"""Masked reductions and scalar DSP helpers (counterpart of
bliss_tpu/ops/reductions.py). Every summary takes an explicit mask, so a
batch of ragged songs reduces in one pass over a padded buffer."""

from __future__ import annotations

import torch


#: Terms a level of `batch_free_sum` adds per output: a CUDA reduction of
#: at most 32 contiguous terms an output gives each output as many threads
#: as it has terms, however many outputs there are.
SUM_CHUNK = 32


def batch_free_sum(x: torch.Tensor, dim=-1) -> torch.Tensor:
    """Sum over `dim` in an order that the other dims' sizes leave alone:
    chunks of `SUM_CHUNK` terms, zero-padded, then the chunks' sums, level
    by level. A CUDA reduction sizes its blocks, and splits an output's
    terms over blocks, by how many outputs there are, so a song's summary
    over its frames would round otherwise in a batch of another size."""
    x = x.movedim(dim, -1)
    while x.shape[-1] > SUM_CHUNK:
        x = torch.nn.functional.pad(x, (0, -x.shape[-1] % SUM_CHUNK))
        x = x.reshape(*x.shape[:-1], -1, SUM_CHUNK).sum(-1)
    return x.sum(-1)


def masked_mean(values: torch.Tensor, mask: torch.Tensor, dim=-1) -> torch.Tensor:
    """Mean over `mask`-selected entries (NaN-safe in masked positions),
    each song's alike in a batch of any size (`batch_free_sum`)."""
    zero = torch.zeros((), dtype=values.dtype, device=values.device)
    n = mask.to(values.dtype).sum(dim)
    return batch_free_sum(torch.where(mask, values, zero), dim) / torch.clamp(n, min=1)


def masked_std(values: torch.Tensor, mask: torch.Tensor, dim=-1) -> torch.Tensor:
    """Population standard deviation (ddof=0) over masked entries, two-pass
    like ndarray's `std_axis` (src/timbral.rs:59-121), each song's alike in
    a batch of any size (`batch_free_sum`)."""
    zero = torch.zeros((), dtype=values.dtype, device=values.device)
    n = torch.clamp(mask.to(values.dtype).sum(dim), min=1)
    mean = batch_free_sum(torch.where(mask, values, zero), dim) / n
    d = torch.where(mask, values - mean.unsqueeze(dim), zero)
    return torch.sqrt(batch_free_sum(d * d, dim) / n)


_SIGNED = {torch.float32: torch.int32, torch.float64: torch.int64}


def _float_sort_key(x: torch.Tensor) -> torch.Tensor:
    """Order-isomorphic SIGNED integer key of an f32/f64 tensor.

    Equal to the JAX package's unsigned key with its top bit flipped,
    read as signed: non-negative floats keep their bits, negative ones
    flip every bit but the sign. int32 for f32, int64 for f64.
    """
    itype = _SIGNED[x.dtype]
    i = x.view(itype)
    low = torch.iinfo(itype).max  # all bits but the sign
    return torch.where(i < 0, i ^ low, i)


def _key_to_float(key: torch.Tensor, dtype) -> torch.Tensor:
    """Inverse of `_float_sort_key`."""
    itype = _SIGNED[dtype]
    key = key.to(itype)
    low = torch.iinfo(itype).max
    return torch.where(key < 0, key ^ low, key).view(dtype)


def _u32_key_to_float(key: torch.Tensor, dtype) -> torch.Tensor:
    """Float of an f32 sort key in the JAX package's unsigned form, held
    as u32 bit patterns in an int64 tensor: flip the top bit to get the
    signed key, then invert it."""
    signed = key ^ (1 << 31)
    return _key_to_float(torch.where(signed >= 1 << 31, signed - (1 << 32), signed), dtype)


def masked_quantile_midpoint(
    values: torch.Tensor, mask: torch.Tensor, q: float = 0.5
) -> torch.Tensor:
    """Quantile with Midpoint interpolation over masked entries of the
    last axis: `(x[floor((n-1)q)] + x[ceil((n-1)q)]) / 2` on the sorted
    valid values (ndarray-stats `Midpoint`, src/temporal.rs:71-76,
    src/chroma.rs:381-384). An all-False mask gives +inf."""
    n = mask.to(torch.int32).sum(-1)
    pos = (n - 1).to(torch.float32) * q
    big = torch.full((), float("inf"), dtype=values.dtype, device=values.device)
    s = torch.sort(torch.where(mask, values, big), dim=-1).values
    last = values.shape[-1] - 1
    lo = torch.clamp(torch.floor(pos).to(torch.int64), 0, last)
    hi = torch.clamp(torch.ceil(pos).to(torch.int64), 0, last)
    vlo = torch.gather(s, -1, lo.unsqueeze(-1)).squeeze(-1)
    vhi = torch.gather(s, -1, hi.unsqueeze(-1)).squeeze(-1)
    return (vlo + vhi) * 0.5


def masked_quantile_midpoint_all(
    values: torch.Tensor, mask: torch.Tensor, q: float = 0.5
) -> torch.Tensor:
    """`masked_quantile_midpoint` over all elements after the batch axis:
    `[B, ...]` in, `[B]` out.

    A CUDA f32 tensor goes through the byte-radix select and its
    `bisect8_keys` kernel at every size, read in place (it must be
    contiguous). The JAX package takes its XLA bisect above an 8 MiB int8
    plane (bliss_tpu/ops/reductions.py:187-190), a bound set by the TPU's
    VMEM, which has no counterpart on the card. Both routes select exactly,
    so the result is the same."""
    b = values.shape[0]
    if values.device.type == "cuda" and values.dtype == torch.float32:
        from .tuning_kernels import masked_quantile_midpoint_radix

        return masked_quantile_midpoint_radix(values, mask, q)
    return masked_quantile_midpoint(values.reshape(b, -1), mask.reshape(b, -1), q)


def geometric_mean(values: torch.Tensor, dim=-1) -> torch.Tensor:
    """Geometric mean of non-negative values; 0 if any value is 0
    (log-domain form of src/utils.rs:101-117)."""
    return torch.exp2(torch.log2(values).mean(dim))


def zero_crossing_count(signal: torch.Tensor, length=None) -> torch.Tensor:
    """Count sign changes of the `x > 0` predicate over `[..., T]`
    (src/utils.rs:81-95). Only the first `length` samples participate;
    `length` broadcasts against the leading axes."""
    t = signal.shape[-1]
    pos = signal > 0
    change = pos[..., 1:] != pos[..., :-1]
    if length is not None:
        idx = torch.arange(1, t, device=signal.device)
        length = torch.as_tensor(length, device=signal.device)
        change = change & (idx < length.unsqueeze(-1))
    return change.to(torch.int32).sum(-1)


def normalize_range(value, min_value: float, max_value: float):
    """Min-max normalization into [-1, 1] (src/utils.rs:70-77)."""
    return 2.0 * (value - min_value) / (max_value - min_value) - 1.0
