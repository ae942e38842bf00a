#!/usr/bin/env python3
"""Time the embedding-bag kernel (K8) at the DLRM bag shape over two
table sizes, beside other sources of the same kernel, on one CUDA card.

    python3 tools/probe_embedding_bag.py [--variant NAME=PATH[:MACRO=VALUE...] ...]
                                         [--rows N ...]

Bags: B 4096 x T 100, ragged (lengths uniform in 1..100, the rest -1)
and full, ids uniform over the table (`chip_smoke.dlrm_bags`), and
ragged with Zipf-skewed ids (`chip_smoke.zipf_bags`, an illustrative
skew: its exponent is not taken from a measurement of real traffic);
tables of 128 columns, fp32 then bf16, 40,000,000 rows (the MLPerf
DLRM-DCNv2 row cap: 20.48 GB in fp32) and 2,000,000 rows (1.02 GB). The
two tables read the same number of rows; where the large one is slower,
the difference is address translation over its pages, not bytes. The
kernel as shipped and each `--variant` (a source with the same C entry:
an earlier one from `git show <commit>:<path>`, or
`tools/embedding_bag_ring.cu`, the ring design; each `:MACRO=VALUE` is
defined at the top of the copy built) are held to the plain version bit
for bit on one set, then timed (device ms per call from replayed CUDA
graphs, `chip_smoke.device_ms`, three input sets cycled) in the order
A B ... B A and averaged. Prints the card and one JSON line; exits 1
without a card.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variant", action="append", default=[], metavar="NAME=PATH[:MACRO=VALUE...]")
    ap.add_argument("--rows", type=int, nargs="*", default=[40_000_000, 2_000_000])
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    import chip_smoke
    from repro_torch.kernels import _build, _launch
    from repro_torch.kernels.embedding_bag import kernel as ek, ref

    print(chip_smoke.card_line())
    where = _build.BUILD_DIR / "probe_embedding_bag"
    where.mkdir(parents=True, exist_ok=True)
    srcs = {}
    for spec in args.variant:
        name, rest = spec.split("=", 1)
        path, *defines = rest.split(":")
        srcs[name] = where / f"embedding_bag_{name}.cu"
        head = "".join(f"#define {d.replace('=', ' ', 1)}\n" for d in defines)
        srcs[name].write_text(head + Path(path).read_text())
    _build.build([ek.SOURCE, *srcs.values()])
    libs = {"shipped": ek.library()}
    for name, path in srcs.items():
        libs[name] = _build.load(path)
        _launch.declare(libs[name], "embedding_bag_launch", "ppp" + "i" * 6 + "p")

    def launcher(lib):
        def call(table, idx):  # as the wrapper launches, without its checks
            out = torch.empty((idx.shape[0], table.shape[1]), dtype=table.dtype,
                              device=table.device)
            err = lib.embedding_bag_launch(
                table.data_ptr(), idx.data_ptr(), out.data_ptr(), idx.shape[0], idx.shape[1],
                table.shape[0], table.shape[1], 0 if table.dtype == torch.float32 else 1,
                ek.vec_width(table), _launch.stream(table.device))
            if err:
                raise RuntimeError(f"embedding_bag_launch returned CUDA error {err}")
            return out
        return call

    fns = {name: launcher(lib) for name, lib in libs.items()}
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(8)
    b, t, d = 4096, 100, 128
    result = {"shape": f"B {b}, T {t}, D {d}", "ms": {}}
    for v in args.rows:
        for dtype in (torch.float32, torch.bfloat16):
            table = torch.randn((v, d), generator=gen, device=dev, dtype=dtype)
            for kind in ("ragged", "full", "skewed"):
                make = (chip_smoke.zipf_bags if kind == "skewed" else
                        lambda *a: chip_smoke.dlrm_bags(*a, full=kind == "full"))
                sets = [(table, make(b, t, v, gen)) for _ in range(3)]
                want = ref.embedding_bag_ref(*sets[0])
                for name, fn in fns.items():
                    if not torch.equal(fn(*sets[0]), want):
                        raise SystemExit(f"{name} differs from the plain version")
                times = {name: [] for name in fns}
                for name in [*fns, *reversed(fns)]:
                    times[name].append(chip_smoke.device_ms(fns[name], sets))
                key = f"{v} rows {'fp32' if dtype == torch.float32 else 'bf16'} {kind}"
                result["ms"][key] = {name: sum(x) / len(x) for name, x in times.items()}
                print(key, json.dumps(result["ms"][key]), flush=True)
            del table, sets, want
            torch.cuda.empty_cache()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
