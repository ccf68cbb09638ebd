"""``step_ms.admit`` read the same way in the cell whose inter-token tail
is ``itl_p95_ms.chat``, which it moves there."""
from portbench.harness import cell


def read(run):
    return cell.reader("step_ms.admit")(run)
