#!/usr/bin/env python3
"""Time the covgrad backward (K3/K4) as it ships, one launch whose last
block of a row adds the row's partials behind a ticket, against the same
kernel with the partials added by a second launch, on one CUDA card.

    python3 tools/probe_bwd_launches.py [--parent-source PATH]

The two-launch variant is the shipped source with one line added (a
launch given no ticket counters stops once its partial is written) and a
finalize kernel of one 256-thread block a row that adds the splits in
order, as the kernel before the single launch did. `--parent-source`
also times an earlier two-launch source (its `snis_bwd_launch` takes no
counters) at its own chunking, four blocks a SM. Shape: fopo-paper's
training step, B 32, S 1000, L 100, P 750,000, every action live (eight
input sets, 102 MB of rows: more than the card's L2), then every action
dead. Device ms per call from replayed CUDA graphs
(`chip_smoke.device_ms`) and eager ms per call (`chip_smoke.time_ms`:
host and device, launches included), measured in the order A B C C B A
and averaged; each variant is launched as the wrapper launches the
kernel, without its argument checks, so the eager times differ only by
the counters' lookup or the second launch. Prints the card and one JSON
line; exits 1 without a card.
"""
from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

STOP = "  __threadfence();  // the partial is visible before the ticket\n"
FINALIZE = r"""
namespace {
__global__ void __launch_bounds__(256) probe_finalize(const float* __restrict__ part,
                                                      float* __restrict__ grad, int splits,
                                                      int L) {
  const int b = blockIdx.x;
  for (int l = threadIdx.x; l < L; l += 256) {
    float sum = 0.f;
    for (int j = 0; j < splits; ++j) sum += part[((size_t)b * splits + j) * L + l];
    grad[(size_t)b * L + l] = sum;
  }
}
}  // namespace

extern "C" int probe_two_launch(const void* coeff, const void* actions, const void* beta,
                                void* part, void* grad, int B, int S, int L, int splits,
                                int chunk, void* stream) {
  const int err = snis_bwd_launch(coeff, actions, beta, part, grad, nullptr, B, S, L, splits,
                                  chunk, stream);
  if (err != 0 || splits == 1) return err;
  probe_finalize<<<B, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(part), static_cast<float*>(grad), splits, L);
  return (int)cudaGetLastError();
}
"""


def sources(parent: Path | None) -> dict[str, Path]:
    """The variant's source (and the parent's), written beside copies of
    the backward's headers in the build directory."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.snis_covgrad import kernel as sk

    text = sk.BWD_SOURCE.read_text()
    if text.count(STOP) != 1:
        raise SystemExit("the backward's source has no single ticket fence to stop at")
    text = text.replace(STOP, "  if (counters == nullptr) return;  // a second launch adds\n"
                        + STOP)
    where = _build.BUILD_DIR / "probe_bwd"
    where.mkdir(parents=True, exist_ok=True)
    for header in sk.BWD_SOURCE.parent.glob("*.cuh"):
        shutil.copy(header, where / header.name)
    out = {"two_launch": where / "snis_covgrad_bwd_two_launch.cu"}
    out["two_launch"].write_text(text + FINALIZE)
    if parent is not None:
        out["parent"] = where / "snis_covgrad_bwd_parent.cu"
        shutil.copy(parent, out["parent"])
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent-source", type=Path, default=None)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    import chip_smoke
    from repro_torch.kernels import _build, _launch
    from repro_torch.kernels.snis_covgrad import kernel as sk

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip().splitlines()[0])
    srcs = sources(args.parent_source)
    _build.build([sk.BWD_SOURCE, *srcs.values()])
    libs = {name: _build.load(path) for name, path in srcs.items()}
    sig = "pppppp" + "iiiii" + "p"
    _launch.declare(libs["two_launch"], "probe_two_launch", sig[:5] + sig[6:])
    if "parent" in libs:
        _launch.declare(libs["parent"], "snis_bwd_launch", sig[:5] + sig[6:])

    dev = torch.device("cuda", 0)
    b, s, l, p = 32, 1000, 100, 750_000
    sms = _launch.sm_count(0)
    gen = torch.Generator(device=dev).manual_seed(0)
    beta = 0.3 * torch.randn((p, l), generator=gen, device=dev)

    def two_launch(lib, fn, per_sm):
        def call(cf, a):
            splits, chunk = sk.splits_for(b, s, sms, per_sm)
            part = torch.empty((b, splits, l), dtype=torch.float32, device=dev)
            grad = torch.empty((b, l), dtype=torch.float32, device=dev)
            err = getattr(lib, fn)(cf.data_ptr(), a.data_ptr(), beta.data_ptr(),
                                   part.data_ptr(), grad.data_ptr(), b, s, l, splits, chunk,
                                   _launch.stream(dev))
            if err:
                raise RuntimeError(f"{fn} returned CUDA error {err}")
            return grad
        return call

    def one_launch(cf, a):  # the wrapper's launch, without its argument checks
        splits, chunk = sk.splits_for(b, s, sms, sk.bwd_per_sm(l))
        lib, stream = sk.bwd_library(), _launch.stream(dev)
        counters = _launch.ticket_counters(dev, stream, b, lib.snis_bwd_capture_id(stream))
        part = torch.empty((b, splits, l), dtype=torch.float32, device=dev)
        grad = torch.empty((b, l), dtype=torch.float32, device=dev)
        err = lib.snis_bwd_launch(cf.data_ptr(), a.data_ptr(), beta.data_ptr(), part.data_ptr(),
                                  grad.data_ptr(), counters.data_ptr(), b, s, l, splits, chunk,
                                  stream)
        if err:
            raise RuntimeError(f"snis_bwd_launch returned CUDA error {err}")
        return grad

    fns = {"one_launch": one_launch,
           "two_launch": two_launch(libs["two_launch"], "probe_two_launch", sk.bwd_per_sm(l))}
    if "parent" in libs:
        fns["parent"] = two_launch(libs["parent"], "snis_bwd_launch", 4)
    result = {"shape": f"B {b}, S {s}, L {l}, P {p}", "ms": {}, "eager_ms": {}}
    for case in ("live", "dead"):
        sets = []
        for _ in range(8):
            a = torch.randint(0, p, (b, s), generator=gen, device=dev, dtype=torch.int32)
            if case == "dead":
                a.fill_(-1)
            sets.append((1e-3 * torch.randn((b, s), generator=gen, device=dev), a))
        want = sk.snis_bwd_cuda(*sets[0], beta)
        for name, fn in fns.items():
            got = fn(*sets[0])
            if name == "two_launch" and not torch.equal(got, want):
                raise SystemExit("the two-launch variant's sums differ from the kernel's")
            scale = float(want.abs().max()) + 1e-30
            if float((got - want).abs().max()) > 1e-5 * scale + 1e-6:
                raise SystemExit(f"{name} disagrees with the kernel ({case})")
        order = [*fns, *reversed(fns)]
        for key, clock in (("ms", chip_smoke.device_ms),
                           ("eager_ms", lambda fn, sets: chip_smoke.time_ms(fn, sets, 200))):
            times = {name: [] for name in fns}
            for name in order:
                times[name].append(clock(fns[name], sets))
            result[key][case] = {name: sum(t) / len(t) for name, t in times.items()}
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
