"""Digests of the flash kernel's outputs at fixed seeded inputs, on the card.

    PYTHONPATH=src python scripts/flash_digests.py [ROOT]

Runs ``ROOT``'s flash kernel (``ROOT/src/repro_torch``, default this
checkout; its kernels build under ``ROOT/build/kernels``) on the cases of
``CASES``: every (q/k, v) head_dim pair of the kernel before prefix-LM,
cross-attention and (256, 256) were added, in both dtypes, causal, with a
window and full, at a ragged S.  Prints one JSON object, case name to the
first 16 hex digits of the SHA-256 of the output's bytes.  Two checkouts
run one after the other in one call give the same digests where their
kernels give the same bits (``tests/test_torch_cuda.py`` holds the current
kernel to the digests recorded from the parent's).
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
DTYPES = ("bfloat16", "float32")


def inputs(case, dtype: str, device):
    """q, k, v of a case, drawn from a numpy seed of its shape."""
    import torch
    B, S, H, KV, d, dv, _, _ = case
    rng = np.random.default_rng(S * 1000 + d + dv + H)
    return tuple(torch.as_tensor(rng.normal(size=(B, S, h, w)),
                                 dtype=torch.float32, device=device)
                 .to(getattr(torch, dtype))
                 for h, w in ((H, d), (KV, d), (KV, dv)))


def digests(attention, device="cuda") -> dict:
    """{"<case> <dtype>": digest} of ``attention.flash_attention``."""
    import torch
    out = {}
    for name, case in CASES:
        for dt in DTYPES:
            q, k, v = inputs(case, dt, device)
            o = attention.flash_attention(q, k, v, causal=case[6],
                                          window=case[7])
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
    print(json.dumps({"root": str(root), "digests": digests(attention)}))


if __name__ == "__main__":
    main()
