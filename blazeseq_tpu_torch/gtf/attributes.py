"""GTF2.2 attribute parsing (reference: blazeseq/_gtf/attributes.mojo).

Format: ``tag "value"; tag "value"; ...``; gene_id and transcript_id are
mandatory first-class fields (empty for inter/inter_CNS). Quoted values
support backslash escapes; unquoted values are accepted."""

from __future__ import annotations

from typing import List, Optional, Tuple

_ESCAPES = {ord('"'): b'"', ord("\\"): b"\\", ord("n"): b"\n",
            ord("t"): b"\t", ord("r"): b"\r"}


class GtfAttributes:
    __slots__ = ("gene_id", "transcript_id", "_extras")

    def __init__(self, gene_id: bytes = b"", transcript_id: bytes = b""):
        self.gene_id = gene_id
        self.transcript_id = transcript_id
        self._extras: List[Tuple[bytes, bytes]] = []

    def get(self, key) -> Optional[bytes]:
        k = key.encode() if isinstance(key, str) else key
        if k == b"gene_id":
            return self.gene_id
        if k == b"transcript_id":
            return self.transcript_id
        for pk, pv in self._extras:
            if pk == k:
                return pv
        return None

    def get_all(self, key) -> List[bytes]:
        k = key.encode() if isinstance(key, str) else key
        if k == b"gene_id":
            return [self.gene_id]
        if k == b"transcript_id":
            return [self.transcript_id]
        return [pv for pk, pv in self._extras if pk == k]

    def items(self):
        return ([(b"gene_id", self.gene_id),
                 (b"transcript_id", self.transcript_id)] + self._extras)

    def __len__(self) -> int:
        return 2 + len(self._extras)

    def to_bytes(self) -> bytes:
        parts = [b'%s "%s";' % (k, v) for k, v in self.items()]
        return b" ".join(parts)

    def __repr__(self) -> str:
        return self.to_bytes().decode("utf-8", "replace")


def _unescape(value: bytes) -> bytes:
    if b"\\" not in value:
        return value
    out = bytearray()
    i = 0
    n = len(value)
    while i < n:
        b = value[i]
        if b == 92 and i + 1 < n and value[i + 1] in _ESCAPES:
            out += _ESCAPES[value[i + 1]]
            i += 2
        else:
            out.append(b)
            i += 1
    return bytes(out)


def parse_gtf_attributes(data: bytes) -> GtfAttributes:
    """Parse GTF column 9 (reference: attributes.mojo:198-...): quote-aware
    splitting on ';', backslash escapes, unquoted values, duplicate keys kept
    in extras."""
    attrs = GtfAttributes()
    n = len(data)
    start = 0
    while start < n:
        while start < n and data[start] in (32, 59):  # ' ' or ';'
            start += 1
        if start >= n:
            break
        # find pair end: next ';' outside quotes
        end = start
        in_quote = False
        while end < n:
            b = data[end]
            if b == 92 and in_quote and end + 1 < n:
                end += 2
                continue
            if b == 34:  # '"'
                in_quote = not in_quote
            if b == 59 and not in_quote:
                break
            end += 1
        part = data[start:end]
        start = end + 1
        sp = part.find(b" ")
        if sp < 0:
            continue
        key = part[:sp]
        raw = part[sp + 1 :].strip(b" ")
        if raw.startswith(b'"'):
            # strip surrounding quotes, unescape
            body = raw[1:]
            if body.endswith(b'"') and not body.endswith(b'\\"'):
                body = body[:-1]
            value = _unescape(body)
        else:
            value = raw
        if key == b"gene_id" and not attrs.gene_id:
            attrs.gene_id = value
        elif key == b"transcript_id" and not attrs.transcript_id:
            attrs.transcript_id = value
        else:
            attrs._extras.append((key, value))
    return attrs
