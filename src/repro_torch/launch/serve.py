"""The serving CLI: the `serving.serve(cfg, workload, ...)` API on the
command line (PyTorch port of ``repro.launch.serve``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-7b \
        --reduced --requests 16 --max-new 16 --pool CXL [--device cpu]

Compares pools with --compare (baseline / +Engram(DRAM) / +Engram(CXL)),
the Table 2 experiment shape. `--replicas N` serves the same workload from
a Router fleet sharing one hot-row cache (the Table 3 DP shape).

The model runs on the card unless ``--device cpu`` (``device="cpu"``)
says otherwise. The Engram tables go where the run's retrieval strategy
puts them (``models.params.table_memory_for``): the engine draws them
there.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys

from ..configs.base import SpecConfig, StoreConfig, get_config
from ..models.transformer import RunFlags
from ..serving import Workload, serve
from .train import reduced_config


def with_store(cfg, *, cache_rows: int = 0, cache_tier: str = "DRAM",
               prefetch_depth: int = 1, admission: str = "lru",
               warm_rows: int = 0, aging_half_life_s: float = 0.0):
    """Return ``cfg`` with tiered-store knobs on its EngramConfig.
    ``warm_rows``/``aging_half_life_s`` size a three-level chain
    (``pool="CXL+SSD"`` specs, pool/tierchain.py): the CXL-resident
    partition and the promotion sketch's virtual-clock decay."""
    if cfg.engram is None:
        return cfg
    scfg = StoreConfig(cache_rows=cache_rows, cache_tier=cache_tier,
                       prefetch_depth=prefetch_depth, admission=admission,
                       warm_rows=warm_rows,
                       aging_half_life_s=aging_half_life_s)
    return dataclasses.replace(
        cfg, engram=dataclasses.replace(cfg.engram, store=scfg))


def run_once(cfg, *, requests: int, max_new: int, pool, params=None,
             max_batch: int = 8, max_len: int = 256, seed: int = 0,
             warmup: bool = False, emulate_step_s=None, cache_rows: int = 0,
             zipf_alpha: float = 0.0, admission: str = "lru",
             spec: SpecConfig = None, prompt_pool: int = 0,
             replicas: int = 1, policy: str = "round_robin",
             shared_cache: bool = True, qps: float = 0.0,
             warm_rows: int = 0, aging_half_life_s: float = 0.0,
             device=None):
    """One workload drive through `serving.serve` (kept as the stable
    knob-level entry the benchmarks call). Returns (frontend, stats):
    the frontend is an `EngramRuntime` (or a `Router` for replicas>1).
    ``device``: the card unless the caller passes ``"cpu"``; ``params``
    must live there."""
    # the reference's deployment default: bf16 score products summed in
    # f32 (attention.f32_bmm), without f32 copies of the KV cache
    flags = RunFlags(attn_bf16_scores=True)
    if cache_rows or warm_rows:
        cfg = with_store(cfg, cache_rows=cache_rows, admission=admission,
                         warm_rows=warm_rows,
                         aging_half_life_s=aging_half_life_s)
    workload = Workload(requests=requests, max_new=max_new,
                        prompt_pool=prompt_pool, zipf_alpha=zipf_alpha,
                        arrival="poisson" if qps > 0 else "batch",
                        qps=qps, seed=seed)
    res = serve(cfg, workload, pool=pool, replicas=replicas, policy=policy,
                shared_cache=shared_cache, warmup=warmup, params=params,
                flags=flags, max_batch=max_batch, max_len=max_len, seed=seed,
                emulate_step_s=emulate_step_s, spec=spec, device=device)
    return res.frontend, res.stats


def run_compare(cfg, *, requests: int, max_new: int, max_batch: int = 8,
                max_len: int = 256, device=None):
    """Table 2 shape: baseline (no engram) vs +Engram(DRAM) vs
    +Engram(CXL), printed one row per variant. The single source of the
    compare experiment — the CLI and examples both call it."""
    base_cfg = dataclasses.replace(cfg, engram=None)
    rows = []
    for name, c, pool in [("baseline", base_cfg, None),
                          ("+Engram (DRAM)", cfg, "DRAM"),
                          ("+Engram (CXL)", cfg, "CXL")]:
        _, stats = run_once(c, requests=requests, max_new=max_new,
                            pool=pool, max_batch=max_batch, max_len=max_len,
                            device=device)
        rows.append((name, stats))
        print(f"{name:18s} {stats.tokens_per_s:8.1f} tok/s "
              f"(stall {stats.stall_s * 1e3:6.1f} ms, "
              f"{stats.decode_steps} decode steps)")
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="deepseek-7b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--pool", default=None,
                    choices=[None, "DRAM", "CXL", "RDMA", "RDMA-agg", "HBM",
                             "CXL+SSD", "DRAM+CXL+SSD"],
                    nargs="?",
                    help="pool tier, or a multi-level chain spec "
                         "(pool/tierchain.py; chains need --warm-rows)")
    ap.add_argument("--cache-rows", type=int, default=0,
                    help="LRU hot-row cache capacity in front of the pool "
                         "tier (0 = off; paper §6 rescue); for a chain "
                         "spec this sizes the DRAM front")
    ap.add_argument("--warm-rows", type=int, default=0,
                    help="chain warm-partition capacity in rows "
                         "(required for --pool CXL+SSD chains)")
    ap.add_argument("--aging-half-life", type=float, default=0.0,
                    help="virtual-clock half-life (s) for the chain's "
                         "promotion-sketch decay (0 = never forget)")
    ap.add_argument("--admission", default="lru",
                    choices=["lru", "tinylfu"],
                    help="hot-row cache admission policy")
    ap.add_argument("--speculate", action="store_true",
                    help="speculative decoding: drafts widen the Engram "
                         "prefetch window to multiple real decode steps")
    ap.add_argument("--spec-proposer", default="ngram",
                    choices=["ngram", "draft"])
    ap.add_argument("--max-draft", type=int, default=3,
                    help="speculated tokens per wave (k)")
    ap.add_argument("--zipf-alpha", type=float, default=0.0,
                    help="Zipf-skewed prompts (the paper's n-gram reuse "
                         "model); feeds both the hot-row cache and the "
                         "n-gram proposer")
    ap.add_argument("--prompt-pool", type=int, default=0,
                    help="draw prompts from a pool of N distinct prompts "
                         "(repeat traffic: the n-gram proposer's and the "
                         "hot-row cache's steady state); 0 = all unique")
    ap.add_argument("--qps", type=float, default=0.0,
                    help="Poisson offered-load arrivals at this rate on "
                         "the fleet's virtual clock (0 = batch arrivals); "
                         "prints virtual TTFT percentiles")
    ap.add_argument("--replicas", type=int, default=1,
                    help="engine replicas behind a Router (DP serving; "
                         ">1 shares one hot-row cache across the fleet)")
    ap.add_argument("--policy", default="round_robin",
                    choices=["round_robin", "least_loaded", "cache_affinity"],
                    help="router dispatch policy (--replicas > 1)")
    ap.add_argument("--private-cache", action="store_true",
                    help="give each replica its own hot-row cache instead "
                         "of the shared one (the baseline the shared "
                         "cache is measured against)")
    ap.add_argument("--compare", action="store_true",
                    help="run baseline / +Engram(DRAM) / +Engram(CXL)")
    ap.add_argument("--device", default=None,
                    help="where the model runs: the CUDA card unless this "
                         "says otherwise (e.g. cpu)")
    args = ap.parse_args(argv)
    if args.admission != "lru" and not args.cache_rows:
        ap.error("--admission needs --cache-rows > 0 (the policy gates "
                 "inserts into the hot-row cache)")
    if args.pool and "+" in args.pool and not args.warm_rows:
        ap.error("a chain pool spec needs --warm-rows > 0 (the "
                 "CXL-resident partition's capacity)")
    if args.compare and (args.speculate or args.cache_rows
                         or args.zipf_alpha or args.prompt_pool
                         or args.replicas > 1):
        ap.error("--compare runs fixed Table 2 variants; it does not "
                 "honour --speculate/--cache-rows/--zipf-alpha/"
                 "--prompt-pool/--replicas — run those as single-pool "
                 "invocations")

    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    spec = SpecConfig(proposer=args.spec_proposer,
                      max_draft=args.max_draft) if args.speculate else None
    if not args.compare:
        eng, stats = run_once(cfg, requests=args.requests,
                              max_new=args.max_new,
                              pool=args.pool, max_batch=args.max_batch,
                              max_len=args.max_len,
                              cache_rows=args.cache_rows,
                              warm_rows=args.warm_rows,
                              aging_half_life_s=args.aging_half_life,
                              admission=args.admission, spec=spec,
                              zipf_alpha=args.zipf_alpha,
                              prompt_pool=args.prompt_pool,
                              replicas=args.replicas, policy=args.policy,
                              shared_cache=not args.private_cache,
                              qps=args.qps, device=args.device)
        label = f"pool={args.pool or 'local'}"
        if args.replicas > 1:
            label += f" x{args.replicas} replicas ({args.policy})"
        print(f"{label}: {stats.generated_tokens} tokens "
              f"in {stats.wall_s:.2f}s = {stats.tokens_per_s:.1f} tok/s "
              f"(stall {stats.stall_s * 1e3:.1f} ms)")
        if args.qps > 0:
            print(f"offered load {args.qps:.0f} qps: "
                  f"virtual time {stats.v_time_s * 1e3:.2f} ms, "
                  f"mean TTFT {stats.mean_ttft_v * 1e6:.1f} us (virtual)")
        if args.speculate:
            print(f"speculate: acceptance={stats.acceptance_rate:.3f} "
                  f"({stats.accepted_tokens}/{stats.proposed_tokens} drafts, "
                  f"{stats.spec_waves} verify waves)")
        if args.replicas > 1:
            rs = eng.stats()
            for name, st in rs.per_replica.items():
                print(f"  {name}: {st.generated_tokens} tokens, "
                      f"{st.prefills} requests, "
                      f"stall {st.stall_s * 1e3:.1f} ms")
            if rs.cache is not None:
                c = rs.cache
                print(f"shared-cache: hit_rate={c.hit_rate:.3f} "
                      f"({c.hits}/{c.hits + c.misses} unique-key accesses, "
                      f"{c.rows}/{c.capacity_rows} rows)")
        elif eng.store is not None and args.pool:
            s = eng.store.stats()
            print(f"store[{s.tier}]: {s.segments} segments, "
                  f"hit_rate={s.hit_rate:.3f} "
                  f"(cache={s.cache_rows} rows @ {s.cache_tier}), "
                  f"stall/wave={s.stall_s_per_wave * 1e6:.1f} us, "
                  f"hidden {s.hidden_waves}/{s.waves} waves")
            if s.spec_waves:
                print(f"spec-prefetch: window={s.spec_window_steps:.2f} "
                      f"decode steps (measured), "
                      f"wasted={s.wasted_prefetch_rate:.3f} of segments")
        return 0

    run_compare(cfg, requests=args.requests, max_new=args.max_new,
                max_batch=args.max_batch, max_len=args.max_len,
                device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
