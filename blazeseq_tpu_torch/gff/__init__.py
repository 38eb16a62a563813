from .attributes import Gff3Attributes, parse_gff3_attributes, percent_decode
from .parser import Gff3LinePolicy, Gff3Parser
from .record import (
    Gff3Record,
    Gff3Strand,
    Gff3View,
    SequenceRegion,
    TargetAttribute,
    parse_target_attribute,
)
