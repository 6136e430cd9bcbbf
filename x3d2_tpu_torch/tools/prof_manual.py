"""The manual entry of the split-TF32 x-apply kernel beside one torch call
(and, in the parity forms, the operator-apply template's x_pfwd / x_pinv),
on the card: the port's counterpart of tools/prof_manual.py, and the entry
point of ops/x_apply_manual.py's manual forms.

    python3 x3d2_tpu_torch/tools/prof_manual.py [n] [iters]
    python3 -m x3d2_tpu_torch.tools.prof_manual [n] [iters]

Builds the operators of x3d2_tpu's tools/prof_manual.py (a 5-point random
circulant stencil, seed 0, times real_dft_matrix(n), forward T Op and
inverse Op T^-1, each divided by its largest eigenvalue modulus) and a
random (n, n, n) float32 field (and s) on the card. For each form (dense,
dense with the subtraction, parity forward, parity inverse, parity inverse
with the subtraction) it times, by CUDA events over a warmed loop of
`iters` calls (default n = 512, 20): the kernel at S = 2, 3, 4, 6, in the
parity forms the template's launch of the same function (operator_apply:
PFWD / PINV along x, x_pfwd / x_pinv), and one torch.matmul (torch.addmm
with the subtraction) of the same product; checks each kernel's result
against the plain float32 and float64 versions (relative to max |plain
float64|: 1e-5 and 3e-5); and prints one JSON line: the card, the forms'
times and errors.
Exits 1 where a check fails, 2 without a card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import torch

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))

from x3d2_tpu_torch.ops import operator_apply as oa  # noqa: E402
from x3d2_tpu_torch.ops import x_apply_manual as xm  # noqa: E402
from x3d2_tpu_torch.ops.matmul_poisson import real_dft_matrix  # noqa: E402

SLOTS = (2, 3, 4, 6)
FORMS = (("dense", None, False), ("dense sub", None, True),
         ("parity fwd", "fwd", False), ("parity inv", "inv", False),
         ("parity inv sub", "inv", True))


def operators(n):
    """(Mf, Mi): x3d2_tpu tools/prof_manual.py's forward- and
    inverse-folded circulant operators, normalised."""
    rng = np.random.default_rng(0)
    sten = rng.standard_normal(5)
    Op = np.zeros((n, n))
    for k, c in zip(range(-2, 3), sten):
        Op += c * np.roll(np.eye(n), k, axis=1)
    T = real_dft_matrix(n)
    Mf, Mi = T @ Op, Op @ np.linalg.inv(T)
    Mf /= np.abs(np.linalg.eigvals(Mf)).max()
    Mi /= np.abs(np.linalg.eigvals(Mi)).max()
    return Mf, Mi


def loop_ms(fn, iters):
    """ms a call over `iters` calls after a warm-up, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def rel(got, ref64):
    return float((got.double() - ref64).abs().max() / ref64.abs().max())


def template(M32, f, s, parity):
    """The template's parity x apply of the same form (one launch)."""
    out = torch.empty((M32.shape[0],) + tuple(f.shape[1:]), device=f.device)
    oa.apply("x_pfwd" if parity == "fwd" else "x_pinv", oa.PFWD
             if parity == "fwd" else oa.PINV, 0, [([M32], [f], out, s)],
             epi=oa.SUB if s is not None else oa.STORE)
    return out


def profile(n=512, iters=20, ny=None, nz=None, dev=None):
    """{form: times and errors} at (n, ny, nz) (default n^3)."""
    dev = dev or torch.device("cuda")
    ny, nz = ny or n, nz or n
    Mf, Mi = operators(n)
    gen = torch.Generator(device=dev).manual_seed(0)
    f = torch.randn((n, ny, nz), generator=gen, device=dev)
    s = torch.randn((n, ny, nz), generator=gen, device=dev)
    out, ok = {}, True
    for label, parity, sub in FORMS:
        fn = {S: xm.make_x_apply_manual(Mi if parity == "inv" else Mf,
                                        sub=sub, parity=parity, slots=S,
                                        device=dev) for S in SLOTS}
        M32, M64 = fn[4].op(torch.float32), fn[4].op(torch.float64)
        s_ = s if sub else None
        p32 = xm.x_apply_manual_plain(M32, f, s_, parity)
        p64 = xm.x_apply_manual_plain(M64, f.double(),
                                      s.double() if sub else None, parity)
        entry = {"plain32_vs_64": rel(p32, p64)}
        checks = {f"manual[S={S}]": fn[S](f, s_) if sub else fn[S](f)
                  for S in SLOTS}
        if parity is not None:
            checks["template"] = template(M32, f, s_, parity)
        for name, got in checks.items():
            e32, e64 = rel(got, p32.double()), rel(got, p64)
            entry[name] = {"rel32": e32, "rel64": e64}
            ok = ok and e32 <= 1e-5 and e64 <= 3e-5
        del checks, p32, p64
        for S in SLOTS:
            entry[f"manual[S={S}]"]["ms"] = loop_ms(
                (lambda S=S: fn[S](f, s_)) if sub else
                (lambda S=S: fn[S](f)), iters)
        if parity is not None:
            entry["template"]["ms"] = loop_ms(
                lambda: template(M32, f, s_, parity), iters)
        # one torch call of the same product: the dense operator over the
        # field as an (n, ny nz) matrix (the parity forms stand for it)
        Md = torch.as_tensor(Mi if parity == "inv" else Mf,
                             dtype=torch.float32, device=dev)
        f2, s2 = f.view(n, -1), s.view(n, -1)
        entry["torch_ms"] = loop_ms(
            (lambda: torch.addmm(s2, Md, f2, alpha=-1.0)) if sub
            else (lambda: torch.matmul(Md, f2)), iters)
        out[label] = entry
        torch.cuda.empty_cache()
    return out, ok


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("no CUDA device: prof_manual times kernels on the card",
              file=sys.stderr)
        return 2
    n = int(argv[0]) if argv else 512
    iters = int(argv[1]) if len(argv) > 1 else 20
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()
    res, ok = profile(n, iters)
    print(json.dumps({"card": card[0] if card else None,
                      "shape": [n, n, n], "iters": iters, "forms": res,
                      "ok": ok}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
