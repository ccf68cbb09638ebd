"""``device_idle_pct`` read the same way in a cell whose end-to-end numbers are
the inter-token gaps and not the rate (prefill-bound document QA), where
it moves ``itl_p95_ms``."""
from portbench.harness import cell


def read(run):
    return cell.reader("device_idle_pct")(run)
