"""Mean seconds of the ``parse`` span a family (the FASTA read, on the
prefetch thread or inline), from the program's own spans (traced runs
only)."""

from portbench.program_spans import mean, program


def read(run):
    return mean(program(run).family_seconds("parse"))
