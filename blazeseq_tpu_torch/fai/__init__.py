from .parser import FaiParser, IndexedFasta, build_fai, write_fai
from .record import FaiRecord, FaiView
