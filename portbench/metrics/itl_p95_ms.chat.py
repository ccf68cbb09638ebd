"""``itl_p95_ms`` read the same way in a cell whose decode wave is bound
by the host (engram27b-pool.chat): its runs spread by the host's speed,
so it has a bound of its own, apart from the steadier cells'."""
from portbench.harness import cell


def read(run):
    return cell.reader("itl_p95_ms")(run)
