from .parser import BedLinePolicy, BedParser, BedWriter
from .record import BedRecord, BedView, ItemRgb, Strand, parse_comma_sep_int_list
