"""Operation counting over the eager program: the PyTorch counterpart of
``repro.roofline.hlo_scale`` (trip-count-aware accounting over
post-optimisation HLO text).

``CountingMode`` is a ``TorchDispatchMode``: every ATen, c10d and custom
operation the step runs passes through it, on real tensors (a step on
the card) or on fake ones (a trace under ``FakeTensorMode``, nothing
allocated, no kernel launched). ``stats()`` returns ``scaled_stats``'
keys:

  * ``flops_dot``      — the matmul family only, as ``_dot_flops`` counts
                         dots: ``mm``, ``bmm``, ``addmm``, ``baddbmm``,
                         their ``out_dtype`` overloads, ``mv``, ``dot``
                         and ``torch._grouped_mm`` at 2 · rows · K · N,
                         K2 (``repro_torch::gated_fuse``) at
                         2 · T · d · (d + F), and K3 (below).
                         Convolutions and elementwise operations are not
                         counted, as in the reference.
  * ``bytes_accessed`` — each operation's operands plus its result. Eager
                         execution has no fusion, so every operation is a
                         kernel boundary (the reference's fusion
                         boundaries). The reference's rules carry over:
                         views and structural operations are free
                         (``_EXCLUDE_BYTES``); an in-place update of a
                         buffer (``index_copy_``, ``index_put_``,
                         ``scatter_``, ... : the dynamic-update-slice rule)
                         is charged its update and indices, not the buffer;
                         a gather (``index_select``, ``embedding``,
                         advanced indexing: the gather and dynamic-slice
                         rule) is charged the rows it reads, not the table.
                         K1 (``repro_torch::engram_gather``) is charged its
                         rows read and written and its ids, K2 the bytes of
                         its bound (h, e, both weights read, the output
                         written): the numerators of the kernels' bounds in
                         ``chip_smoke.py``. K3
                         (``repro_torch::decode_attention``) is charged
                         ``kernels.decode_attn.ops.cost``: its score and
                         value products (in ``flops_dot``, 4 · Hq · D a
                         key) and the bytes of the keys it may attend, K
                         and V read once, plus the new rows, q and the
                         output. The positions are on the device, so a
                         row's keys are the bound that the shapes give:
                         the cache's length, or the window where that is
                         shorter, the same on real and fake tensors. An
                         expanded operand is charged its distinct
                         elements.
  * ``collectives``    — ``analysis.collective_stats`` of the c10d calls,
                         each with its payload and its process group's
                         size.

Eager execution runs every iteration of every loop, so there is no trip
count to recover, with two exceptions where the dry run's sequence
lengths make tens of thousands of small operations a layer: a recurrent
mixer's scan over positions and chunked attention's loop over KV blocks
(``models.loops.trips``). Under ``sample_loops(mode, k)`` such a loop
over fake or meta tensors runs only its first k + 1 iterations: the first
counts once, and what the next k count, forward and backward, is scaled
by (n - 1) / k, as the reference scales a while loop's body by its trip
count; a scan's stacked output is still allocated whole
(``models.loops.stack_positions``), though its list of per-position
outputs then holds k + 1 of them, not n. A loop over real tensors runs
and counts every iteration, and a mode that samples refuses an operation
on a real tensor.

``LiveBytes`` tracks the storages that are alive (held by any tensor,
view or autograd graph) and their peak, from the operations' results,
for ``launch.dryrun``'s ``peak_bytes_est``. A sampled loop's storages
that outlive it stand for the iterations not run: those held by each of
the first k - 1 sampled iterations (the states and per-position values
autograd keeps for the backward, one set per iteration) are counted
(n - 2) / (k - 1) times from the loop's end until they are freed, and
the last iteration's (its set and the carry it hands on) once, so the
loop holds n sets and one carry, as its whole run does. A loop the
backward recomputes (a remat period's) is counted as run: scaled at its
end, its storages outlive the whole run's, which the backward frees
position by position.
"""
from __future__ import annotations

import contextlib
import threading
import weakref
from collections import Counter

import torch
import torch.utils.checkpoint
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from ..kernels.decode_attn.ops import cost as k3_cost
from ..kernels.decode_attn.ops import kv_heads_read
from ..models.loops import abstract, sampling
from .analysis import collective_stats

# no traffic: structural operations (the reference's parameter, tuple,
# bitcast, iota, ...) and allocations without a fill
_EXCLUDE_BYTES = {
    "aten::empty", "aten::empty_like", "aten::empty_strided",
    "aten::new_empty", "aten::new_empty_strided", "aten::arange",
    "aten::_unsafe_view", "aten::_reshape_alias", "aten::lift_fresh",
    "aten::_local_scalar_dense", "aten::set_", "aten::resize_",
    "aten::is_nonzero", "aten::record_stream",
}

# queries of a tensor's metadata, which fake tensors answer through the
# dispatcher and real ones do not: not operations at all
_METADATA = {"prim::device", "aten::sym_size", "aten::sym_stride",
             "aten::sym_numel", "aten::sym_storage_offset",
             "aten::_has_compatible_shallow_copy_type"}

# operations that write their mutated operand without reading it
_WRITE_ONLY = {"aten::copy_", "aten::fill_", "aten::zero_",
               "aten::normal_", "aten::uniform_", "aten::bernoulli_",
               "aten::random_", "aten::exponential_"}

# in-place updates of a buffer: the dynamic-update-slice rule
_UPDATE = {"aten::index_copy_", "aten::index_copy", "aten::index_put_",
           "aten::index_put", "aten::_index_put_impl_", "aten::scatter_",
           "aten::scatter", "aten::scatter_add_", "aten::scatter_add",
           "aten::scatter_reduce_", "aten::index_add_", "aten::index_add",
           "aten::masked_scatter_", "aten::slice_scatter",
           "aten::select_scatter", "aten::index_fill_"}

# reads of rows out of a larger operand: the gather / dynamic-slice rule
_GATHER = {"aten::index_select", "aten::embedding", "aten::index",
           "aten::gather", "aten::take", "aten::take_along_dim"}

_DOTS = {"aten::mm", "aten::bmm", "aten::addmm", "aten::baddbmm",
         "aten::mv", "aten::addmv", "aten::dot", "aten::vdot",
         "aten::_grouped_mm"}

_C10D = {"c10d::allreduce_": "all-reduce",
         "c10d::_allgather_base_": "all-gather",
         "c10d::_reduce_scatter_base_": "reduce-scatter",
         "c10d::alltoall_base_": "all-to-all"}

K1 = "repro_torch::engram_gather"
K2 = "repro_torch::gated_fuse"
K3 = "repro_torch::decode_attention"


def tensor_bytes(t: torch.Tensor) -> int:
    """Bytes of the distinct elements ``t`` addresses: an expanded (stride
    0) dim counts once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


def _tensors(tree) -> list:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _group_size(args) -> int:
    for a in args:
        if isinstance(a, torch.ScriptObject):
            try:
                return torch._C._distributed_c10d.ProcessGroup.unbox(a).size()
            except RuntimeError:
                continue              # a ReduceOp, not a ProcessGroup
    raise ValueError("a c10d operation without a process group")


def _dot_flops(name: str, args, out: torch.Tensor) -> float:
    if name in ("aten::addmm", "aten::baddbmm", "aten::addmv"):
        a = args[1]
    else:
        a = args[0]
    if name in ("aten::dot", "aten::vdot"):
        return 2.0 * a.numel()
    k = a.shape[-1]
    if name == "aten::_grouped_mm" and a.dim() == 2 and args[1].dim() == 2:
        k = k / out.shape[0]          # groups split the contraction
    return 2.0 * out.numel() * k


def _kernel_stats(name: str, args, out: torch.Tensor) -> tuple:
    """(flops, bytes) of a call of K1, K2 or K3, from its operands."""
    if name == K1:
        tables, gid = args
        L, N = gid.shape
        row = tables[0].shape[-1] * tables[0].element_size()
        return 0.0, L * (2 * N * row + 8 * N)
    if name == K3:
        q, _, _, k_cache, _, _, window, _, group, q_offset = args
        B, S, Hc, D = k_cache.shape
        keys = min(S, window) if window > 0 else S
        return k3_cost(q.shape[1], kv_heads_read(q.shape[1], group,
                                                 q_offset),
                       Hc, D, k_cache.element_size(), B, B * keys)
    h, e, wg, wp = args
    d, F = h.shape[-1], e.shape[-1]
    T = h.numel() // d
    return (2.0 * T * d * (d + F),
            h.element_size() * (2 * T * d + T * F + d * d + F * d))


class LiveBytes:
    """The bytes of the storages held alive, and their peak. ``hold``
    registers a tensor's storage once (a view adds nothing); the bytes are
    released when the storage is freed (a weak reference to it)."""

    def __init__(self):
        self.current = 0
        self.peak = 0
        self._refs = {}
        self._bytes = {}             # key -> the bytes it is counted as
        self._since = None           # a sampled loop's keys, by iteration

    def hold(self, t: torch.Tensor) -> int:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._refs:
            return 0
        nb = st.nbytes()
        self._refs[key] = weakref.ref(st, lambda _, k=key:
                                      self._release(k))
        self._bytes[key] = nb
        if self._since:
            self._since[-1].append(key)
        self.current += nb
        self.peak = max(self.peak, self.current)
        return nb

    def _release(self, key) -> None:
        if self._refs.pop(key, None) is not None:
            self.current -= self._bytes.pop(key)

    @contextlib.contextmanager
    def scaled(self, n: int, k: int):
        """Inside: the k sampled iterations of a loop of n after its
        first, each begun by a call of the function it yields. At its end
        the storages each iteration but the last held and are still alive
        are counted (n - 2) / (k - 1) times (their bytes so far times that,
        so nested loops multiply; with k = 1, the last iteration's are
        counted n - 1 times)."""
        outer, self._since = self._since, []
        try:
            yield lambda: self._since.append([])
        finally:
            segs, self._since = self._since, outer
            if torch._C._current_graph_task_id() != -1:
                segs = []             # a remat recompute: counted as run
            last = set(segs[-1]) if segs else set()
            if k > 1:
                factor = (n - 2) / (k - 1)
                keys = set().union(*segs[:-1]) - last
            else:
                factor, keys = n - 1, last
            for key in keys:    # a freed storage's key may come back
                if key in self._refs:
                    extra = self._bytes[key] * (factor - 1)
                    self._bytes[key] += extra
                    self.current += extra
            self.peak = max(self.peak, self.current)
            if outer:
                outer[-1].extend(set().union(*segs) if segs else ())


_LOCAL = threading.local()   # the scale of a sampled loop, per thread


def _scale() -> float:
    return getattr(_LOCAL, "scale", 1.0)


class CountingMode(TorchDispatchMode):
    """Count the FLOPs, bytes and collectives of what runs under it (the
    module docstring). ``memory``: a ``LiveBytes`` fed every result.
    ``sample_loops`` makes it sample loops."""

    def __init__(self, memory: LiveBytes | None = None):
        super().__init__()
        self.memory = memory
        self.sampling = False
        self.flops = 0.0
        self.bytes = 0.0
        self.calls = []              # (kind, bytes, group size, scale)
        self.kernel_calls = Counter()
        self.n_ops = 0.0
        self.sampled = []            # (n, k) of each sampled loop
        self.nodes = {}              # id -> (autograd node, scale)

    def __exit__(self, *exc):
        self.nodes.clear()
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self.sampling:
            _refuse_real(func, args, kwargs)
        out = func(*args, **kwargs)
        self._account(func, args, kwargs, out)
        if self.memory is not None:
            for t in _tensors(out):
                self.memory.hold(t)
        return out

    def _account(self, func, args, kwargs, out) -> None:
        name = func._schema.name
        if name in _METADATA:
            return
        m = _scale()
        if self.nodes:
            node = torch._C._current_autograd_node()
            if node is not None:
                m = self.nodes.get(id(node), (None, m))[1]
        self.n_ops += m
        if name in (K1, K2, K3):
            f, b = _kernel_stats(name, args, out)
            self.flops += m * f
            self.bytes += m * b
            self.kernel_calls[name] += m
            return
        if name in _C10D:
            if name == "c10d::allreduce_":
                size = sum(tensor_bytes(t) for t in args[0])
            else:
                size = tensor_bytes(args[0])     # the output buffer
            self.calls.append((_C10D[name], size, _group_size(args), m))
        if name in _DOTS:
            self.flops += m * _dot_flops(name, args, out)
        if func.is_view or name in _EXCLUDE_BYTES:
            return
        schema = func._schema.arguments
        written = {i for i, a in enumerate(schema)
                   if a.alias_info is not None and a.alias_info.is_write}
        operand_b = []
        for i, a in enumerate(args):
            if i in written and name in _WRITE_ONLY:
                continue
            operand_b += [tensor_bytes(t) for t in _tensors(a)]
        operand_b += [tensor_bytes(t) for t in _tensors(kwargs)]
        res_b = sum(tensor_bytes(t) for t in _tensors(out))
        b = res_b + sum(operand_b)
        if operand_b and name in _UPDATE:
            big = max(operand_b)
            if abs(big - res_b) <= 0.05 * max(res_b, 1):
                b = sum(operand_b) - big
        elif operand_b and name in _GATHER:
            big = max(operand_b)
            if big > 2.0 * max(res_b, 1):
                b = res_b + sum(operand_b) - big + res_b
        self.bytes += m * b

    def stats(self) -> dict:
        """``scaled_stats``' keys, plus the kernels' call counts, the
        operations counted and the loops sampled."""
        return {
            "flops_dot": self.flops,
            "bytes_accessed": self.bytes,
            "collectives": collective_stats(
                [(k, m * size, n) for k, size, n, m in self.calls]),
            "kernel_calls": dict(self.kernel_calls),
            "n_ops": self.n_ops,
            "sampled_loops": len(self.sampled),
        }


class _ScaleBackward(TorchFunctionMode):
    """During a sampled loop's iterations: every autograd node created
    there (those its results lead back to, down to the loop's first
    sequence number, composite operations' inner nodes included) is
    registered with ``mode``, whose operations then count at the loop's
    scale while that node runs in backward (its own kernels and the sums
    of the gradients it passes on)."""

    def __init__(self, mode: "CountingMode", scale: float):
        super().__init__()
        self.mode = mode
        self.scale = scale
        self.first = torch._C._autograd._get_sequence_nr()

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        todo = [t.grad_fn for t in _tensors(out) if t.grad_fn is not None]
        while todo:
            node = todo.pop()
            if node is None or id(node) in self.mode.nodes or \
                    node.name() == "torch::autograd::AccumulateGrad" or \
                    node._sequence_nr() < self.first:
                continue
            self.mode.nodes[id(node)] = (node, self.scale)
            todo.extend(nxt for nxt, _ in node.next_functions)
        return out


def _refuse_real(func, args, kwargs) -> None:
    """A sampling mode counts traces, never a computation whose answer
    matters: an operation on a tensor that holds data (a 0-dim CPU tensor,
    which PyTorch takes as a scalar, aside) raises."""
    for t in _tensors((args, kwargs)):
        if not abstract(t) and not (t.dim() == 0 and t.device.type == "cpu"):
            raise RuntimeError(f"{func}: a counting mode that samples loops "
                               f"runs on fake or meta tensors only, got a "
                               f"{t.device.type} tensor of {tuple(t.shape)}")


class LoopSampler:
    """What ``models.loops.trips`` runs a sampled loop under: the k
    iterations after the first count, forward and backward, (n - 1) / k
    times each in ``mode``."""

    def __init__(self, mode: CountingMode, k: int):
        self.mode = mode
        self.k = k

    @contextlib.contextmanager
    def loop(self, n: int):
        """Yields the function each iteration begins with (``LiveBytes.
        scaled``'s, or None without a ``memory``)."""
        self.mode.sampled.append((n, self.k))
        prev = _scale()
        _LOCAL.scale = prev * (n - 1) / self.k
        mem = self.mode.memory
        kept = mem.scaled(n, self.k) if mem is not None \
            else contextlib.nullcontext()
        try:
            with _ScaleBackward(self.mode, _LOCAL.scale), kept as begin:
                yield begin
        finally:
            _LOCAL.scale = prev


@contextlib.contextmanager
def sample_loops(mode: CountingMode, k: int):
    """Inside: the loops of ``models.loops.trips`` over fake or meta
    tensors run k + 1 iterations, counted in ``mode`` as the whole loop,
    and ``mode`` refuses operations on real tensors."""
    mode.sampling = True
    try:
        # a remat period's recompute runs to its end: stopped early, it
        # would leave a sampled loop open (its scale still set) until the
        # loop's generator is collected
        with sampling(LoopSampler(mode, k)), \
                torch.utils.checkpoint.set_checkpoint_early_stop(False):
            yield mode
    finally:
        mode.sampling = False


__all__ = ["CountingMode", "LiveBytes", "LoopSampler", "sample_loops",
           "tensor_bytes", "K1", "K2", "K3"]
