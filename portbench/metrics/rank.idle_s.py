"""Mean device-idle seconds inside each family's ``rank`` span (the host
sort), from the program's spans on the trace's clock (traced runs
only)."""

from portbench.program_spans import mean, program


def read(run):
    return mean(program(run).family_idle("rank"))
