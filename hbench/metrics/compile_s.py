"""compile_s: the harness clock around compile_graph and the capturing first
call (every bucket's, behind the server)."""


def read(run):
    return run.compile_s
