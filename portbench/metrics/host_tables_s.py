"""Host clock around placing the Engram tables in pinned host memory:
mapping and registering the buffers (the port's ``host_empty``), drawing
the rows on the card and copying them down. Cells whose tables lie in
host memory."""


def read(run):
    return run.host_tables_s
