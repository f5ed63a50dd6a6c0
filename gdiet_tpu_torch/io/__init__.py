"""Host-side sequence I/O: FASTA/FASTQ reading and SAM/PAF writing."""
