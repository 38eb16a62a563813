"""Device half of the FASTQ batch layer (the host half is imported from
blazeseq_tpu.fastq unchanged)."""
