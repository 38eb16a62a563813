"""The FASTQ host layer (parser, records, quality schemas, index, paired
readers) and the batch layer with its device upload."""
