"""K5 designs measured against the kept kernel on a CUDA card.

The kept K5 kernel (``dj_brdf_torch/csrc/merl_gather.cu``, one position
a thread through L2) against the designs of ``gather_designs.cu`` that
were measured and not kept: a persistent grid with 16-B index loads and
eight gathers in flight a thread; and a share of the plane held in the
shared memory of thread-block clusters, its lookups mixed into the same
warps or handed to helper warps. At chip_smoke.py's phase-7 shape (a
uniform-random 1,458,000-entry plane, 2^22 uniform indices), each design
is held bit for bit against ``plane[idx]`` and timed in device time
(torch.profiler), in turns with the kept kernel.

    python scripts/gather_designs.py [--out results.json]
"""

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from dj_brdf_torch.ops import _build  # noqa: E402
from dj_brdf_torch.ops import merl_gather as mg  # noqa: E402

# (design, CTAs a cluster, share of the plane held)
CLUSTER_DESIGNS = [("mixed", 16, 0.2), ("mixed", 16, 0.34),
                   ("mixed", 8, 0.2), ("helpers", 16, 0.2),
                   ("helpers", 16, 0.34), ("helpers", 8, 0.1)]


def build():
    out = _build.BUILD_DIR / "gather_designs"
    out.mkdir(parents=True, exist_ok=True)
    lib = out / "libgather_designs.so"
    done = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
         str(ROOT / "scripts" / "gather_designs.cu")],
        capture_output=True, text=True)
    if done.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{done.stdout}{done.stderr}")
    so = ctypes.CDLL(str(lib))
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    so.design_persistent.argtypes = [i32, ptr, i64, ptr, i64, ptr, ptr]
    so.design_plane_bytes.argtypes = [i32, i32, ctypes.POINTER(i32)]
    so.design_clusters.argtypes = [i32, i32, ptr, i64, ptr, i64, i32, i32,
                                   i32, i32, ptr, ptr, ctypes.POINTER(i32)]
    for fn in (so.design_persistent, so.design_plane_bytes,
               so.design_clusters):
        fn.restype = ctypes.c_int
    return so


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", default=None,
                        help="also write the results to this JSON file")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("gather_designs: needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    so = build()
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    plane = torch.rand(cs.N_MERL, generator=gen, device="cuda")
    idx = torch.randint(0, cs.N_MERL, (cs.N_GATHER,), generator=gen,
                        device="cuda", dtype=torch.int32)
    want = plane[idx]
    out = torch.empty_like(want)
    stream = torch.cuda.current_stream().cuda_stream

    def check(err, what):
        if err != 0:
            raise RuntimeError(f"{what}: CUDA error {err}")

    designs = {"kept": lambda: mg.kernel_gather_plane(plane, idx),
               "persistent": lambda: check(so.design_persistent(
                   0, plane.data_ptr(), plane.numel(), idx.data_ptr(),
                   idx.numel(), out.data_ptr(), stream), "persistent")}
    shapes = {}
    for kind, size, share in CLUSTER_DESIGNS:
        helpers = int(kind == "helpers")
        avail = ctypes.c_int()
        check(so.design_plane_bytes(0, helpers, ctypes.byref(avail)), kind)
        slots = min(int(share * cs.N_MERL) // (size * 1024),
                    avail.value // 4096)
        held = slots * size * 1024
        resident = ctypes.c_int()
        check(so.design_clusters(0, helpers, plane.data_ptr(), plane.numel(),
                                 idx.data_ptr(), idx.numel(), held, size,
                                 slots, 1, out.data_ptr(), stream,
                                 ctypes.byref(resident)), kind)
        name = f"{kind} C={size} held {held / cs.N_MERL:.3f}"
        shapes[name] = {"cluster_ctas": size, "slots": slots, "held": held,
                        "clusters": resident.value}
        designs[name] = (
            lambda h=helpers, n=name: check(so.design_clusters(
                0, h, plane.data_ptr(), plane.numel(), idx.data_ptr(),
                idx.numel(), shapes[n]["held"], shapes[n]["cluster_ctas"],
                shapes[n]["slots"], shapes[n]["clusters"], out.data_ptr(),
                stream, None), n))
    for name, fn in designs.items():
        out.zero_()
        got = fn()
        torch.cuda.synchronize()
        if not torch.equal(out if got is None else got, want):
            raise AssertionError(f"{name} differs from plane[idx]")
    runs = {name: [] for name in designs}
    order = list(designs)
    for turn in (order, order[::-1]):
        for name in turn:
            runs[name].append(cs.device_ms(designs[name], 20))
    kept = min(runs["kept"])
    results = {"card": card, "n": cs.N_GATHER, "plane": cs.N_MERL,
               "designs": {}}
    for name, ms in runs.items():
        results["designs"][name] = {"runs_ms": ms, "ms": min(ms),
                                    "over_kept": min(ms) / kept,
                                    **shapes.get(name, {})}
        print(f"{name}: {min(ms):.5f} ms device time (runs {ms}), "
              f"{min(ms) / kept:.3f} of the kept kernel"
              + (f", {shapes[name]}" if name in shapes else ""), flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(results, indent=1))
    print(json.dumps(results["designs"]))


if __name__ == "__main__":
    main()
