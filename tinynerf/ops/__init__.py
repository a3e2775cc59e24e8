from .interp import (
    bilinear_lookup,
    bilinear_lookup_mixed,
    bilinear_lookup_quad,
    sawtooth,
    trilinear_lookup,
    trilinear_lookup_mixed,
    trilinear_lookup_oct,
)
from .trunc_exp import truncated_exp
from .weights import (
    compute_weights,
    compute_weights_naive,
    compute_weights_packed,
    packed_runs,
)

__all__ = [
    "bilinear_lookup",
    "bilinear_lookup_mixed",
    "bilinear_lookup_quad",
    "trilinear_lookup",
    "trilinear_lookup_mixed",
    "trilinear_lookup_oct",
    "sawtooth",
    "truncated_exp",
    "compute_weights",
    "compute_weights_naive",
    "compute_weights_packed",
    "packed_runs",
]
