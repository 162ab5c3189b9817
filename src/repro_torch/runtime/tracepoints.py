"""Trace points of the pivot loops.

``pivot(loop)`` marks the top of each pivot of ``core.lp_kernel._solve``
and ``core.distributed.solve_lp_dist``.  It does nothing but read one
module global unless a listener is set: the traced contracts
(``repro_torch.analysis.contracts.OpTrace``) set one while they trace, to
count pivots and to attribute each host read, collective and dense pass
to the pivot it ran in.
"""
from __future__ import annotations

from typing import Callable, Optional

_listener: Optional[Callable[[str], None]] = None


def pivot(loop: str) -> None:
    """The top of one pivot of the loop named ``loop``."""
    fn = _listener
    if fn is not None:
        fn(loop)


def set_listener(fn: Optional[Callable[[str], None]]
                 ) -> Optional[Callable[[str], None]]:
    """Make ``fn`` the listener (None: none); returns the one before."""
    global _listener
    prev, _listener = _listener, fn
    return prev
