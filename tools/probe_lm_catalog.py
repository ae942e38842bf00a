#!/usr/bin/env python3
"""How the FOPO-LM cell's catalog shapes K7's work, on one CUDA card:
the IVF lists and the probe's time over unembeddings of the cell's size
(`trinity-mini.fopo-lm-s8k`: 200,192 rows of 2048), each indexed as the
cell indexes its own (C 1024, 12 Lloyd iterations, deterministic
algorithms) and probed as the cell probes it (n_probe 8, top 128).

    python3 tools/probe_lm_catalog.py [--queries 16384] [--reps 5]

Run from the root of a checkout. Catalogs: `lm_gen.clustered_unembedding`
with the traffic's 1024 planted clusters (as many as the index has
lists) and spread; the same with 4096 (a count that is not the index's);
and isotropic rows (standard normal over sqrt(d)). The queries are
standard normal rows, as the final RMS norm at unit gain leaves a hidden
state. For each catalog: the list sizes (mean, largest, their ratio, the
spread as std / mean), the padded capacity and the bytes of the padded
lists, the live rows a query's 8 lists hold (mean), and K7's device ms
for all the queries (the median of ``reps`` calls, CUDA events), with
the padded lists' bytes past ``--max-list-gb`` reported but not probed.
Prints the card and one JSON line a catalog; exits 2 without a card.
"""
from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CELL = "trinity-mini.fopo-lm-s8k"


def catalogs(traffic: dict, vocab: int, d: int, device):
    """(name, [V, d] fp32) of each catalog, from the traffic's data seed."""
    import torch

    from bench.drivers.fopo_lm import DATA_STREAM
    from bench.yardstick import gen, lm_gen

    spread = traffic["unembed_spread"]
    for clusters in (traffic["unembed_clusters"], 4096):
        g = gen.device_generator(device, traffic["data_seed"], DATA_STREAM)
        yield (f"planted_{clusters}",
               lm_gen.clustered_unembedding(vocab, d, clusters, spread, g))
    g = gen.device_generator(device, traffic["data_seed"], DATA_STREAM)
    yield "isotropic", torch.randn((vocab, d), generator=g, device=device).div_(math.sqrt(d))


def probe(beta, route: dict, top_k: int, queries, reps: int, index_seed: int,
          max_list_gb: float) -> dict:
    import torch

    from bench.reference.sasrec import deterministic
    from repro_torch.core.fopo import FOPOConfig
    from repro_torch.core.plan import ExecutionPlan
    from repro_torch.mips import ivf

    c = route["num_clusters"]
    gen = torch.Generator(device=beta.device).manual_seed(index_seed)
    with deterministic():
        centroids, assign = ivf.kmeans(beta, c, route["kmeans_iters"], generator=gen)
    sizes = torch.bincount(assign.long(), minlength=c).double()
    mean, biggest = float(sizes.mean()), int(sizes.max())
    cap = 2 ** math.ceil(math.log2(biggest))
    list_bytes = c * cap * beta.shape[1] * 4
    probed = torch.topk(queries @ centroids.T, route["n_probe"], dim=1).indices
    out = {"list_mean": mean, "list_max": biggest, "max_over_mean": biggest / mean,
           "std_over_mean": float(sizes.std() / sizes.mean()), "cap": cap,
           "padded_list_bytes": list_bytes,
           "probed_live_rows_mean": float(sizes[probed].sum(dim=1).mean())}
    if list_bytes > max_list_gb * 1e9:
        out["k7_ms"] = None
        return out
    lists, embs = ivf.bucket_items(assign, beta, c, cap)
    index = ivf.IVFIndex(centroids, lists, embs, num_items=beta.shape[0])
    fopo = FOPOConfig(num_items=beta.shape[0], num_samples=256, top_k=top_k, epsilon=0.5,
                      retriever="ivf_pallas")
    plan = ExecutionPlan.resolve(fopo, retriever_kwargs={"index": index,
                                                         "n_probe": route["n_probe"]})
    del index, lists, embs
    plan.retriever(queries, beta)  # the first call builds K7
    ms = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        plan.retriever(queries, beta)
        b.record()
        torch.cuda.synchronize()
        ms.append(a.elapsed_time(b))
    out["k7_ms"] = statistics.median(ms)
    del plan
    torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--queries", type=int, default=16384)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--max-list-gb", type=float, default=40.0)
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from bench import harness
    from bench.drivers.fopo_lm import INDEX_STREAM, INT32_MAX
    from bench.yardstick import gen

    if not torch.cuda.is_available():
        print("probe_lm_catalog reads the card: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    dev = torch.device("cuda")
    cell = harness.Cell.find(CELL)
    c, t = cell.config, cell.traffic
    index_seed = gen.sub_seed(t["data_seed"], INDEX_STREAM) % INT32_MAX
    q = torch.randn((args.queries, c["hidden_size"]),
                    generator=torch.Generator(device=dev).manual_seed(0), device=dev)
    for name, beta in catalogs(t, c["vocab_size"], c["hidden_size"], dev):
        line = {"catalog": name, **probe(beta, t["route"], c["top_k"], q, args.reps,
                                         index_seed, args.max_list_gb)}
        print(json.dumps(line), flush=True)
        del beta
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
