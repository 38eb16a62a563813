from .parser import FastaBatch, FastaParser, FastaParserConfig
from .record import FastaRecord
