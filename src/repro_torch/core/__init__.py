"""Package-query pipeline of the port (mirrors ``repro.core``).

Unlike the reference, importing this package changes no global numeric
setting: every torch tensor names its dtype (float64 wherever the
reference computes in float64).
"""
