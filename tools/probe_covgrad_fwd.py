#!/usr/bin/env python3
"""Time the covgrad forward (K1/K2) as it ships beside other sources of
it, in both modes, on one CUDA card.

    python3 tools/probe_covgrad_fwd.py --variant NAME=PATH [--variant ...]

A `--variant` is another `snis_covgrad_fwd.cu`, for example an earlier
one from `git show <commit>:src/repro_torch/kernels/snis_covgrad/csrc/
snis_covgrad_fwd.cu`. How it is launched is read from its C entry
`snis_fwd_launch`: with the shipped entry's int arguments it is launched
as the wrapper launches the shipped source (`kernel.snis_fwd_cuda`, its
library in place of the shipped one); with the entry that has no
`lanes` argument (the first design's), at that design's chunks of
32-sample rounds (`kernel.splits_for` with its default multiple). Shape:
fopo-paper's training step, B 32, S 1000, L 100, P 750,000, uniform
actions; input sets: 4 (the timing `chip_smoke.py` has kept from the
first port), 1 (its rows in the 50 MB L2), 9 (115 MB of rows, past L2)
and 4 with every action dead (row 0 alone). Each variant is checked
against the shipped source on one set (scores and g within
`chip_smoke.close_err(..., sums=True)`), then timed (device ms per call
from replayed CUDA graphs, `chip_smoke.device_ms`) in the order A B ...
B A and averaged. Prints the card and one JSON line; exits 1 without a
card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def int_args(source: Path) -> list[str]:
    """The names of the int arguments of the source's `snis_fwd_launch`."""
    m = re.search(r"int snis_fwd_launch\(([^)]*)\)", source.read_text())
    if m is None:
        raise SystemExit(f"{source} has no snis_fwd_launch")
    return [p.split()[-1] for p in m.group(1).split(",") if p.split()[0] == "int"]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variant", action="append", required=True, metavar="NAME=PATH")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    import chip_smoke
    from repro_torch.kernels import _build, _launch
    from repro_torch.kernels.snis_covgrad import kernel as sk

    print(chip_smoke.card_line())
    shipped_args = int_args(sk.FWD_SOURCE)
    first_args = [a for a in shipped_args if a != "lanes"]
    where = _build.BUILD_DIR / "probe_covgrad_fwd"
    where.mkdir(parents=True, exist_ok=True)
    for header in sk.FWD_SOURCE.parent.glob("*.cuh"):
        shutil.copy(header, where / header.name)
    srcs = {}
    for spec in args.variant:
        name, path = spec.split("=", 1)
        srcs[name] = where / f"snis_covgrad_fwd_{name}.cu"
        shutil.copy(path, srcs[name])
    _build.build([sk.FWD_SOURCE, *srcs.values()])

    dev = torch.device("cuda", 0)
    b, s, l, p = 32, 1000, 100, 750_000
    gen = torch.Generator(device=dev).manual_seed(0)
    beta = 0.3 * torch.randn((p, l), generator=gen, device=dev)

    def as_wrapped(lib):
        def fwd(h, a, lq, r, covgrad):
            shipped = sk.fwd_library
            sk.fwd_library = lambda: lib
            try:
                return sk.snis_fwd_cuda(h, beta, a, lq, r, covgrad=covgrad)
            finally:
                sk.fwd_library = shipped
        return fwd

    def as_first_design(lib):
        def fwd(h, a, lq, r, covgrad):
            splits, chunk = sk.splits_for(b, s, _launch.sm_count(0))
            scores = torch.empty((b, s), device=dev)
            part = torch.empty((b, splits, 3 + 2 * l), device=dev)
            grad = torch.empty((b, l), device=dev)
            err = lib.snis_fwd_launch(h.data_ptr(), beta.data_ptr(), a.data_ptr(),
                                      lq.data_ptr(), r.data_ptr(), scores.data_ptr(),
                                      part.data_ptr(), grad.data_ptr(), b, s, l, splits, chunk,
                                      int(covgrad), _launch.stream(dev))
            if err:
                raise RuntimeError(f"snis_fwd_launch returned CUDA error {err}")
            return (scores, grad) if covgrad else scores
        return fwd

    fns = {"shipped": lambda h, a, lq, r, covgrad: sk.snis_fwd_cuda(h, beta, a, lq, r,
                                                                    covgrad=covgrad)}
    for name, src in srcs.items():
        lib = _build.load(src)
        got = int_args(src)
        if got not in (shipped_args, first_args):
            raise SystemExit(f"{name}: snis_fwd_launch takes ints {got}, expected "
                             f"{shipped_args} or {first_args}")
        _launch.declare(lib, "snis_fwd_launch", "p" * 8 + "i" * len(got) + "p")
        _launch.declare(lib, "snis_fwd_error_string", "i", ctypes.c_char_p)
        fns[name] = (as_wrapped if got == shipped_args else as_first_design)(lib)

    def make(n, dead=False):
        out = []
        for _ in range(n):
            a = torch.randint(0, p, (b, s), generator=gen, device=dev, dtype=torch.int32)
            out.append((torch.randn((b, l), generator=gen, device=dev), a.fill_(-1) if dead else a,
                        torch.randn((b, s), generator=gen, device=dev) - 5,
                        (torch.rand((b, s), generator=gen, device=dev) < 0.3).float()))
        return out

    result = {"shape": f"B {b}, S {s}, L {l}, P {p}", "ms": {}}
    for set_name, sets in (("4 sets", make(4)), ("1 set, L2-hot", make(1)),
                           ("9 sets, past L2", make(9)),
                           ("4 sets, every action dead", make(4, True))):
        for covgrad in (False, True):
            calls = {k: (lambda *x, fn=fn, cg=covgrad: fn(*x, cg)) for k, fn in fns.items()}
            want = calls["shipped"](*sets[0])
            for k, fn in calls.items():
                got = fn(*sets[0])
                for x, y in zip(got if covgrad else (got,), want if covgrad else (want,)):
                    chip_smoke.close_err(x, y, f"{set_name}: {k} vs shipped", sums=True)
            times = {k: [] for k in calls}
            for k in [*calls, *reversed(calls)]:
                times[k].append(chip_smoke.device_ms(calls[k], sets))
            key = f"{set_name}, {'covgrad' if covgrad else 'scores'} mode"
            result["ms"][key] = {k: sum(t) / len(t) for k, t in times.items()}
            print(key, json.dumps(result["ms"][key]), flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
