"""Mean number of device operations (kernels, copies, sets) launched
inside each completed family's ``family`` span: the program's own spans
on the trace's clock (``program_spans``; traced runs only)."""

from portbench.program_spans import mean, program


def read(run):
    return mean(program(run).family_launches())
