"""Digests of the flash kernel's outputs at fixed seeded inputs, on the card.

    PYTHONPATH=src python scripts/flash_digests.py [ROOT]

Runs ``ROOT``'s flash kernel (``ROOT/src/repro_torch``, default this
checkout; its kernels build under ``ROOT/build/kernels``) on the cases of
``CASES``: every (q/k, v) head_dim pair of the kernel before prefix-LM,
cross-attention and (256, 256) were added, in both dtypes, causal, with a
window and full, at a ragged S; and on ``EXTRA_CASES``: (256, 256) under
each mask, prefix-LM and cross-attention (Sq != Sk).  Prints one JSON
object, case name to the first 16 hex digits of the SHA-256 of the
output's bytes: ``digests`` and ``extra`` from the forward-only launch
and, where the checkout's forward can also write each row's log-sum-exp
(``flash_attention_fwd(..., want_lse=True)``), ``digests_lse`` and
``extra_lse`` of the output of that launch.  Two checkouts run one after
the other in one call give the same digests where their kernels give the
same bits (``tests/test_torch_cuda.py`` holds the current kernel to the
digests recorded from the parent's).
"""
from __future__ import annotations

import hashlib
import json
import sys
from pathlib import Path

import numpy as np

# (name, (B, S, H, KV, d, dv, causal, window))
CASES = tuple(
    (f"{d}x{dv} {mode}", (2, 200, H, KV, d, dv, causal, window))
    for d, dv, H, KV in ((64, 64, 6, 2), (120, 120, 6, 2), (128, 128, 6, 2),
                         (192, 128, 4, 4))
    for mode, causal, window in (("causal", True, 0), ("window", True, 70),
                                 ("full", False, 0)))
# (name, (B, S, H, KV, d, dv, causal, window, prefix, Sk))
EXTRA_CASES = tuple(
    (f"256x256 {mode}", (2, 200, 8, 1, 256, 256, causal, window, 0, 200))
    for mode, causal, window in (("causal", True, 0), ("window", True, 70),
                                 ("full", False, 0))) + (
    ("128x128 prefix", (2, 200, 6, 2, 128, 128, True, 0, 37, 200)),
    ("256x256 prefix", (2, 200, 8, 1, 256, 256, True, 0, 37, 200)),
    ("128x128 cross", (2, 200, 6, 2, 128, 128, False, 0, 0, 333)),
    ("64x64 cross", (2, 200, 6, 2, 64, 64, False, 0, 0, 77)))
DTYPES = ("bfloat16", "float32")


def inputs(case, dtype: str, device):
    """q, k, v of a case, drawn from a numpy seed of its shape."""
    import torch
    B, S, H, KV, d, dv = case[:6]
    Sk = case[9] if len(case) > 9 else S
    rng = np.random.default_rng(S * 1000 + d + dv + H + (Sk - S))
    return tuple(torch.as_tensor(rng.normal(size=(B, n, h, w)),
                                 dtype=torch.float32, device=device)
                 .to(getattr(torch, dtype))
                 for n, h, w in ((S, H, d), (Sk, KV, d), (Sk, KV, dv)))


def digests(attention, device="cuda", cases=CASES, lse: bool = False
            ) -> dict:
    """{"<case> <dtype>": digest} of ``attention.flash_attention`` (with
    ``lse``: of the output of ``flash_attention_fwd(..., want_lse=True)``)."""
    import torch
    out = {}
    for name, case in cases:
        kw = dict(causal=case[6], window=case[7])
        if len(case) > 8 and case[8]:
            kw["prefix"] = case[8]
        for dt in DTYPES:
            q, k, v = inputs(case, dt, device)
            o = attention.flash_attention_fwd(q, k, v, want_lse=True,
                                              **kw)[0] if lse \
                else attention.flash_attention(q, k, v, **kw)
            raw = o.cpu().contiguous().view(torch.uint8).numpy().tobytes()
            out[f"{name} {dt}"] = hashlib.sha256(raw).hexdigest()[:16]
    return out


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    root = Path(argv[0] if argv else Path(__file__).resolve().parents[1])
    sys.path.insert(0, str(root.resolve() / "src"))
    import torch
    if not torch.cuda.is_available():
        sys.exit("flash_digests: needs a CUDA card")
    from repro_torch.kernels import attention
    out = {"root": str(root), "digests": digests(attention),
           "extra": digests(attention, cases=EXTRA_CASES)}
    if hasattr(attention, "flash_attention_fwd"):
        out["digests_lse"] = digests(attention, lse=True)
        out["extra_lse"] = digests(attention, cases=EXTRA_CASES, lse=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
