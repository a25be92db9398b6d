"""Fixed-point quantization for the digital datapath (paper Sec. V-A2).

The port of ``repro.core.quant``:

  * sensory inputs are uniformly quantized to 4-bit by the ADC,
  * linear-classifier weights/biases are quantized with a symmetric
    per-classifier power-of-two scale,
  * digital-RBF support vectors / dual coefficients are quantized to 8 bit.

The device-side functions take and return tensors and compute in f32, as
the reference does on its device (``FixedPoint`` quantizes host weights in
f32 too: that is what the reference's ``jnp.asarray`` of a host array
does without 64-bit mode).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

# ---------------------------------------------------------------------------
# Uniform affine quantization in [0, 1] — the ADC model
# ---------------------------------------------------------------------------


def quantize_unit(x: torch.Tensor, bits: int = 4) -> torch.Tensor:
    """Uniformly quantize values in [0, 1] to ``bits`` (ADC of Fig. 1).

    Returns the dequantized value the digital datapath computes with;
    values outside [0, 1] saturate like a real ADC.  ``torch.round``
    rounds half to even, as ``jnp.round`` does.
    """
    levels = (1 << bits) - 1
    xq = torch.round(torch.clamp(x, 0.0, 1.0) * levels)
    return xq / levels


def quantize_unit_codes(x: torch.Tensor, bits: int = 4) -> torch.Tensor:
    """Integer ADC codes in [0, 2^bits - 1]."""
    levels = (1 << bits) - 1
    return torch.round(torch.clamp(x, 0.0, 1.0) * levels).to(torch.int32)


# ---------------------------------------------------------------------------
# Symmetric fixed-point for weights / support vectors / coefficients
# ---------------------------------------------------------------------------


def _as_f32(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    return torch.as_tensor(np.asarray(x), dtype=torch.float32)


@dataclasses.dataclass(frozen=True)
class FixedPoint:
    """Symmetric fixed-point code: value = code * 2^-frac_bits, |code| < 2^(bits-1)."""

    bits: int
    frac_bits: int

    @property
    def scale(self) -> float:
        return 2.0 ** (-self.frac_bits)

    def quantize(self, x) -> torch.Tensor:
        qmax = (1 << (self.bits - 1)) - 1
        code = torch.clamp(torch.round(_as_f32(x) / self.scale), -qmax, qmax)
        return code * self.scale

    def codes(self, x) -> torch.Tensor:
        qmax = (1 << (self.bits - 1)) - 1
        return torch.clamp(torch.round(_as_f32(x) / self.scale),
                           -qmax, qmax).to(torch.int32)


def best_frac_bits(x: np.ndarray, bits: int) -> int:
    """Pick frac_bits so the largest |x| just fits (bespoke per-classifier scale).

    ``qmax * 2^-frac >= amax``  =>  ``frac <= log2(qmax) - log2(amax)``,
    clamped to the f32-safe exponent range (codes are computed in f32).
    The difference of logs stays finite for a subnormal ``amax``, where
    the quotient ``qmax / amax`` would overflow.
    """
    amax = float(np.max(np.abs(x))) if np.size(x) else 1.0
    if amax <= 0:
        return bits - 1
    qmax = (1 << (bits - 1)) - 1
    frac = np.floor(np.log2(qmax) - np.log2(amax) + 1e-9)
    return int(np.clip(frac, -(126 - bits), 126))


def quantize_tensor(x: np.ndarray, bits: int) -> tuple[np.ndarray, FixedPoint]:
    fp = FixedPoint(bits=bits, frac_bits=best_frac_bits(x, bits))
    return fp.quantize(x).numpy(), fp


# ---------------------------------------------------------------------------
# Bespoke-hardware weight analysis (drives the cost model of hwcost.py)
# ---------------------------------------------------------------------------


def csd_nonzero_digits(code: int) -> int:
    """Number of non-zero digits in the canonical signed digit form of ``code``.

    A bespoke constant multiplier costs one adder per CSD non-zero digit
    minus one; zero / power-of-two weights cost no multiplier at all.
    """
    c = abs(int(code))
    count = 0
    while c:
        if c & 1:
            # canonical recoding: runs of 1s become +/- pair
            if (c & 3) == 3:
                c += 1  # use a -1 digit
            count += 1
        c >>= 1
    return count


def weight_hardware_class(code: int) -> str:
    """'zero' | 'pow2' | 'general' — cost classes of a hardwired weight."""
    c = abs(int(code))
    if c == 0:
        return "zero"
    if (c & (c - 1)) == 0:
        return "pow2"
    return "general"
