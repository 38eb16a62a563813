"""GFF3 attribute parsing + RFC 3986 percent-decoding
(reference: blazeseq/_gff/attributes.mojo)."""

from __future__ import annotations

from typing import List, Optional, Tuple

_HEX = {ord(c): i for i, c in enumerate("0123456789abcdef")}
_HEX.update({ord(c): i for i, c in enumerate("0123456789ABCDEF")})


def percent_decode(data: bytes) -> bytes:
    """RFC 3986 percent-decode; malformed escapes pass through verbatim
    (reference: attributes.mojo:126-176)."""
    if b"%" not in data:
        return data
    out = bytearray()
    i = 0
    n = len(data)
    while i < n:
        b = data[i]
        if b == 37 and i + 2 < n and data[i + 1] in _HEX and data[i + 2] in _HEX:
            out.append(_HEX[data[i + 1]] * 16 + _HEX[data[i + 2]])
            i += 3
        else:
            out.append(b)
            i += 1
    return bytes(out)


class Gff3Attributes:
    """Parsed GFF3 attributes: ordered (key, [values]) pairs with typed
    accessors for the reserved attributes (attributes.mojo:16-124)."""

    __slots__ = ("_pairs",)

    def __init__(self):
        self._pairs: List[Tuple[bytes, List[bytes]]] = []

    def add(self, key: bytes, value: bytes) -> None:
        self._pairs.append((key, [value]))

    def add_multi(self, key: bytes, values: List[bytes]) -> None:
        self._pairs.append((key, list(values)))

    def get(self, key) -> Optional[bytes]:
        k = key.encode() if isinstance(key, str) else key
        for pk, vals in self._pairs:
            if pk == k:
                return vals[0] if vals else None
        return None

    def get_all(self, key) -> List[bytes]:
        k = key.encode() if isinstance(key, str) else key
        out: List[bytes] = []
        for pk, vals in self._pairs:
            if pk == k:
                out.extend(vals)
        return out

    def __len__(self) -> int:
        return len(self._pairs)

    def items(self):
        return list(self._pairs)

    # reserved attributes
    def id(self) -> Optional[bytes]:
        return self.get(b"ID")

    def name(self) -> Optional[bytes]:
        return self.get(b"Name")

    def parent(self) -> List[bytes]:
        return self.get_all(b"Parent")

    def aliases(self) -> List[bytes]:
        return self.get_all(b"Alias")

    def note(self) -> Optional[bytes]:
        return self.get(b"Note")

    def derives_from(self) -> Optional[bytes]:
        return self.get(b"Derives_from")

    def dbxref(self) -> List[bytes]:
        return self.get_all(b"Dbxref")

    def ontology_term(self) -> List[bytes]:
        return self.get_all(b"Ontology_term")

    def is_circular(self) -> bool:
        v = self.get(b"Is_circular")
        return v == b"true"

    def to_bytes(self) -> bytes:
        """key=value;key=val1,val2 (attributes.mojo:109-124)."""
        return b";".join(k + b"=" + b",".join(v) for k, v in self._pairs)

    def __repr__(self) -> str:
        return self.to_bytes().decode("utf-8", "replace")


def parse_gff3_attributes(data: bytes) -> Gff3Attributes:
    """Parse GFF3 column 9: semicolon-separated key=value with comma
    multi-values; '.' means no attributes (attributes.mojo:178-234)."""
    attrs = Gff3Attributes()
    if not data:
        return attrs
    if data.rstrip(b" \r\n") == b".":
        return attrs
    for part in data.split(b";"):
        part = part.strip(b" ")
        if not part:
            continue
        eq = part.find(b"=")
        if eq < 0:
            continue
        key = percent_decode(part[:eq])
        values = [percent_decode(v) for v in part[eq + 1 :].split(b",") if v]
        if values:
            attrs.add_multi(key, values)
    return attrs
