"""Where K2's, K4's and K5's time goes: their launches timed with parts cut
out.

    python -m vdnerf_tpu_torch.tools.kernel_cuts [--iters 20] [--cuts none no_input ...]

``ncu`` does not run on the card's machine, so this tool answers "what
limits the tile kernels" the way a profiler's stall breakdown would, by
subtraction. For each cut it copies this package under
``ops/kernels/_build/cuts/<cut>/``, removes one part of
``csrc/fused_mlp.cu`` by an exact textual replacement (the tool fails if
the text is not there once), builds that copy and times, with CUDA events and
weights packed once, the full-width ``womsk_white_tpu`` launches: K2 at a
serving chunk's rows (393,216), K4 at a chunk's (135,168) and K5's tile
kernel at a training step's outside rows (16,896). A cut kernel computes
wrong numbers; only its time is read. ``sync_mma`` is a variant, not a cut:
K5's wgmmas complete slab by slab, as K2's and K4's do. Prints the card's
name and power limit, then one JSON line per cut with its times, each tile
kernel's registers and spill bytes from ptxas, and the kernels for which
ptxas reports serialised wgmmas (C7512) or an injected wait (C7517).
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path

PKG = Path(__file__).resolve().parents[1]
CUTS_DIR = PKG / "ops" / "kernels" / "_build" / "cuts"

# cut name -> [(text in csrc/fused_mlp.cu, its replacement)]
CUTS = {
    "none": [],
    # every product's wgmma (the ring still loads, the epilogues still run)
    "no_mma": [("    if (pr.mn) rb_mma_pick<RG::kAsync, NCH, 1>(mine, full, acc, Atile, lda, k0, Bs, wg);\n"
                "    else rb_mma_pick<RG::kAsync, NCH, 0>(mine, full, acc, Atile, lda, k0, Bs, wg);\n",
                "")],
    # the weight ring's bulk copies, and the waits for them (the wgmmas read
    # whatever the stages hold; no copy is left in flight when a CTA exits)
    "no_load": [("      mbar_wait(cur.bars + s % ST, (s / ST) & 1);\n", ""),
                ("      if (threadIdx.x == 0) cur.load<RG>(p, W, ring, (s + RG::kLead) % ST);\n", ""),
                ("        if (threadIdx.x == 0) load<RG>(p, W, ring, j);\n", "")],
    # K5's acts/dels stores to global memory
    "no_store": [("  const int n_kg = width >> 3;\n", "  const int n_kg = 0 * (width >> 3);\n")],
    # K2's feature block: zeros in place of its global loads
    "no_input": [("            v = __ldg(reinterpret_cast<const float4*>(src));\n", "")],
    # not a cut: K5's wgmmas complete slab by slab, as K4's do
    "sync_mma": [("using K5Ring = Ring<6, true, true>;", "using K5Ring = Ring<6, false, true>;")],
}

KERNELS = ("render_fwd_kernel", "render_bwd_kernel", "nerf_fwd_kernel", "nerf_bwd_kernel")

_TIMER = r'''
import json, sys, torch
sys.path.insert(0, sys.argv[1])
from vdnerf_tpu_torch.ops.kernels import fused_mlp
iters = int(sys.argv[2])
dev = torch.device("cuda:0")
g = torch.Generator().manual_seed(0)
def lin(k, n):
    return (torch.randn(k, n, generator=g) / k ** 0.5).to(dev), (torch.randn(n, generator=g) * 0.05).to(dev)
t = [lin(84, 256)] + [lin(256, 256) for _ in range(4)] + [lin(340, 256)] + [lin(256, 256) for _ in range(2)]
h = [lin(256, 1), lin(256, 256), lin(283, 128), lin(128, 3)]
plan = (10, 4, (4,), 8, False)
packed = fused_mlp._nerf_pack(plan, 4, [w for w, _ in t], [b for _, b in t], [w for w, _ in h],
                              [b for _, b in h], dev)
meta = packed[2]
def inputs(n):
    p = torch.randn(n, 3, generator=g); p = p / p.norm(dim=-1, keepdim=True)
    v = torch.randn(n, 3, generator=g); v = v / v.norm(dim=-1, keepdim=True)
    return torch.cat([p, torch.rand(n, 1, generator=g)], -1).to(dev), v.to(dev)
def time_ms(fn):
    fn(); torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters): fn()
    b.record(); torch.cuda.synchronize()
    return a.elapsed_time(b) / iters
pts, views = inputs(135168)
k4 = time_ms(lambda: fused_mlp._nerf_fwd_run(pts, views, packed, False))
n = 16896
pts, views = inputs(n)
gs = [torch.randn(n, k, generator=g).to(dev) for k in (1, 3)]
sc = fused_mlp._BwdScratch(n, meta, dev)
outs = [torch.empty_like(pts), torch.empty_like(views)]
k5 = time_ms(lambda: fused_mlp._nerf_bwd_tile((pts, views, *gs, gs[1]), outs, packed, sc))
del pts, views, gs, sc, outs
r = [lin(289, 256)] + [lin(256, 256) for _ in range(3)] + [lin(256, 3)]
n = 393216
x = [torch.randn(n, 3, generator=g).to(dev) for _ in range(3)] + [(torch.randn(n, 256, generator=g) * 0.5).to(dev)]
rpacked = fused_mlp._render_pack(("idr", 4, True), x[3], [w for w, _ in r], [b for _, b in r], dev)
k2 = time_ms(lambda: fused_mlp._render_fwd_run(*x, rpacked))
print(json.dumps({"k2_393216_ms": k2, "k4_135168_ms": k4, "k5_tile_16896_ms": k5}))
'''


def ptxas_notes(log: str) -> dict:
    """Per tile kernel: ptxas's registers and spill-store bytes, and the
    kernels with a serialised-wgmma (C7512) or injected-wait (C7517) note."""
    regs, spills, cur = {}, {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line or "Function properties for" in line:
            cur = next((k for k in KERNELS if k in line), None)
        elif cur and "spill stores" in line:
            spills[cur] = int(line.split("bytes spill stores")[0].split(",")[-1])
        elif cur and "Used" in line and "registers" in line:
            regs[cur] = int(line.split("Used")[1].split("registers")[0])
    notes = {code: sorted({k for line in log.splitlines() if code in line
                           for k in KERNELS if k in line})
             for code in ("C7512", "C7517")}
    return {"registers": regs, "spill_store_bytes": spills,
            "serialized_wgmma": notes["C7512"], "injected_wait": notes["C7517"]}


def make_variant(name: str) -> Path:
    root = CUTS_DIR / name
    if root.exists():
        shutil.rmtree(root)
    shutil.copytree(PKG, root / PKG.name,
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    src = root / PKG.name / "ops" / "kernels" / "csrc" / "fused_mlp.cu"
    text = src.read_text()
    for old, new in CUTS[name]:
        if text.count(old) != 1:
            raise SystemExit(f"kernel_cuts: cut {name!r} does not match the source once")
        text = text.replace(old, new)
    src.write_text(text)
    return root


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--iters", type=int, default=20)
    parser.add_argument("--cuts", nargs="*", default=list(CUTS))
    args = parser.parse_args(argv)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip()
    print(card)
    for name in args.cuts:
        root = make_variant(name)
        out = subprocess.run([sys.executable, "-c", _TIMER, str(root), str(args.iters)],
                             capture_output=True, text=True)
        if out.returncode != 0:
            print(out.stderr[-3000:], file=sys.stderr)
            return 1
        log = (root / PKG.name / "ops" / "kernels" / "_build" / "fused_mlp.log").read_text()
        print(json.dumps({"cut": name, **json.loads(out.stdout.strip().splitlines()[-1]),
                          **ptxas_notes(log)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
