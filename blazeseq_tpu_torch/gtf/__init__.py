from .attributes import GtfAttributes, parse_gtf_attributes
from .parser import GtfParser, GtfRecord, GtfStrand, GtfView
