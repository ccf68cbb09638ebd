"""Serve an Engram model from a simulated CXL pool through the
request-lifecycle `EngramRuntime` API, reproducing the Table 2 comparison
(baseline / +Engram DRAM / +Engram CXL) and streaming tokens per request.

All pool behaviour — tier latency, the optional LRU hot-row cache, and
prefetch-window stalls — comes from the tiered EngramStore subsystem
(src/repro_torch/pool/store.py); the runtime steps the engine one
admit+decode wave at a time and routes every token to its request's handle.
PyTorch port of ``examples/serve_pooled.py``: the model runs on the card
unless ``--device cpu`` says otherwise.

    PYTHONPATH=src python -m repro_torch.examples.serve_pooled [--requests 8]
    # paper §6 rescue, end-to-end: RDMA backing tier + DRAM hot-row cache
    PYTHONPATH=src python -m repro_torch.examples.serve_pooled --pool RDMA \
        --cache-rows 100000
    # §3.2 deep lookahead: speculative decoding widens the prefetch window
    PYTHONPATH=src python -m repro_torch.examples.serve_pooled --pool RDMA \
        --speculate
"""
import argparse
import sys

from repro_torch.configs.base import SpecConfig
from repro_torch.launch.serve import run_compare, with_store
from repro_torch.launch.train import reduced_config
from repro_torch.serving import EngramRuntime, Workload


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=None,
                    help="default 8 (12 with --speculate: enough replays "
                         "of the hot prompt to show the widened window)")
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--pool", default=None,
                    choices=["DRAM", "CXL", "RDMA", "RDMA-agg", "HBM"])
    ap.add_argument("--cache-rows", type=int, default=0,
                    help="LRU hot-row cache rows in front of --pool")
    ap.add_argument("--admission", default="lru",
                    choices=["lru", "tinylfu"],
                    help="cache admission policy (tinylfu = scan-resistant)")
    ap.add_argument("--speculate", action="store_true",
                    help="speculative decoding (n-gram proposer)")
    ap.add_argument("--device", default=None,
                    help="the CUDA card unless this says otherwise (cpu)")
    args = ap.parse_args(argv)
    if args.admission != "lru" and not args.cache_rows:
        ap.error("--admission needs --cache-rows (the policy gates inserts "
                 "into the hot-row cache)")
    if args.cache_rows and not args.pool:
        ap.error("--cache-rows needs --pool (the cache fronts a backing "
                 "tier; compare mode runs fixed variants)")
    if args.speculate and not args.pool:
        ap.error("--speculate needs --pool (compare mode runs the fixed "
                 "Table 2 variants; speculation would change all three)")
    requests = args.requests if args.requests is not None \
        else (12 if args.speculate else 8)

    cfg = reduced_config("deepseek-7b")
    if args.cache_rows:
        cfg = with_store(cfg, cache_rows=args.cache_rows,
                         admission=args.admission)
    spec = SpecConfig(proposer="ngram") if args.speculate else None
    # repeat traffic from a hot prompt under --speculate: replayed greedy
    # continuations are what the n-gram proposer accepts on (unique-random
    # traffic would honestly show ~0% acceptance), and a narrow batch
    # keeps replays *behind* the first request instead of in cold lockstep
    workload = Workload(requests=requests, max_new=args.max_new,
                        prompt_pool=1 if args.speculate else 0)
    max_batch = 2 if args.speculate else 4

    if args.pool is None:
        run_compare(cfg, requests=requests, max_new=args.max_new,
                    max_batch=max_batch, max_len=64, device=args.device)
        return 0

    # single-pool run, driven by hand to show the lifecycle surface:
    # submit -> handles, step -> TokenEvents, per-handle token streams
    rt = EngramRuntime(cfg, pool=args.pool, max_batch=max_batch,
                       max_len=64, spec=spec, device=args.device)
    handles = [rt.submit(list(spec_.prompt), spec_.max_new)
               for spec_ in workload.build(cfg.vocab_size)]
    if handles:
        first = handles[0]
        print(f"request {first.rid} streams:",
              " ".join(str(t) for t in first.stream()))
    stats = rt.drain()                   # finish the rest
    print(f"pool={args.pool}: {stats.generated_tokens} tokens "
          f"from {stats.requests_completed} requests = "
          f"{stats.tokens_per_s:.1f} tok/s "
          f"(stall {stats.stall_s * 1e3:.1f} ms, "
          f"mean TTFT {stats.mean_ttft_s * 1e3:.1f} ms)")
    if args.speculate:
        print(f"speculate: acceptance={stats.acceptance_rate:.3f} "
              f"({stats.accepted_tokens}/{stats.proposed_tokens} drafts)")
    s = rt.store.stats()
    print(f"store[{s.tier}]: {s.segments} segments, "
          f"hit_rate={s.hit_rate:.3f} "
          f"(cache={s.cache_rows} rows @ {s.cache_tier}), "
          f"hidden {s.hidden_waves}/{s.waves} waves")
    if s.spec_waves:
        print(f"spec-prefetch: window={s.spec_window_steps:.2f} decode "
              f"steps (measured), wasted={s.wasted_prefetch_rate:.3f} "
              f"of segments")
    return 0


if __name__ == "__main__":
    sys.exit(main())
