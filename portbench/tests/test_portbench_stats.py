"""The window's arithmetic: percentiles, censored gaps and first tokens,
and the trace's union of device intervals and operator attribution."""
import pytest

from portbench.harness import stats
from portbench.harness.drive import Req
from portbench.harness.trace import Ev, _union, analyse


def test_nearest_rank_percentile():
    v = list(range(1, 101))
    assert stats.percentile(v, 95) == 95
    assert stats.percentile(v, 90) == 90
    assert stats.percentile([3.0], 95) == 3.0
    assert stats.percentile([5, 1, 4, 2, 3], 50) == 3
    with pytest.raises(ValueError):
        stats.percentile([], 50)


def _req(t_submit, stamps, t_done=None):
    r = Req(0, [1], 4, t_submit)
    r.stamps = list(stamps)
    r.t_done = t_done
    return r


def test_gaps_inside_the_window_and_censored_at_its_close():
    done = _req(0.0, [1.0, 2.0, 4.0], t_done=4.0)
    open_ = _req(0.0, [9.0, 9.5])
    # window [1.5, 10): done's gaps start at 2.0 (2.0 long); open_'s start
    # at 9.0 (0.5) and 9.5 (open at the close: 0.5 so far); the gap from
    # 1.0 starts before the window
    g = sorted(stats.gaps([done, open_], 1.5, 10.0))
    assert g == pytest.approx([0.5, 0.5, 2.0])
    # a gap running past the close counts to the close
    assert stats.gaps([_req(0.0, [9.0, 12.0], 12.0)], 1.0, 10.0) == \
        pytest.approx([1.0])


def test_ttft_censored_for_requests_still_waiting():
    reqs = [_req(1.0, [1.5]), _req(2.0, []), _req(0.5, [3.0]),
            _req(9.0, [11.0])]
    # submitted inside [1, 10): 0.5, waited 8.0, 1.0 (to the close)
    assert sorted(stats.ttfts(reqs, 1.0, 10.0)) == \
        pytest.approx([0.5, 1.0, 8.0])


def test_tokens_counted_inside_the_window():
    reqs = [_req(0.0, [1.0, 2.0, 3.0]), _req(0.0, [2.5, 11.0])]
    assert stats.tokens_in(reqs, 1.0, 10.0) == 3


def test_union_counts_overlaps_once():
    assert _union([(0, 10), (5, 15), (20, 30), (30, 31), (2, 3)]) == \
        [[0, 15], [20, 31]]


def _host(name, t0, t1, corr, tid=1, shapes=()):
    return Ev(name, False, t0, t1, tid, corr, 0, list(shapes),
              name.startswith("portbench."))


def _dev(name, t0, t1, linked):
    return Ev(name, True, t0, t1, 0, 0, linked, [], False)


def test_analyse_window_busy_gaps_and_operator_time():
    ev = [
        _dev("spin_kernel", 0, 50, 0),            # the marker
        _dev("lost", 10, 20, 0),                  # before the marker: out
        _host("portbench.window", 100, 1100, 1),
        # a record_function range on the device's timeline: no work
        Ev("portbench.step", True, 100, 1000, 0, 0, 0, [], True),
        _host("portbench.step", 100, 1000, 2),
        _host("repro_torch::gated_fuse", 200, 300, 3,
              shapes=[[8, 1, 64], [8, 1, 32], [64, 64], [32, 64]]),
        _host("cudaLaunchKernel", 250, 260, 4),
        _dev("gated_fuse_bf16", 400, 500, 4),     # linked to the launch
        _dev("gemm", 450, 700, 9),                # overlaps: union 400-700
        _host("aten::mm", 600, 900, 9),
    ]
    a = analyse(ev)
    assert a["marker_found"]
    assert a["window_ns"] == (100, 1100)
    assert a["busy_ns"] == 300
    assert dict(a["device_ops"]) == {"gated_fuse_bf16": 100, "gemm": 250}
    calls = a["op_calls"]["repro_torch::gated_fuse"]
    assert calls == [([[8, 1, 64], [8, 1, 32], [64, 64], [32, 64]], 100)]
    gaps = dict(a["idle_gaps"])
    # 100-400: midpoint 250 inside the launch; 700-1100: midpoint 900,
    # the end of aten::mm
    assert gaps == {"cudaLaunchKernel": 300, "aten::mm": 400}
