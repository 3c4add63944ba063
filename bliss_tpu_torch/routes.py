"""Which kernel carries each descriptor's transform.

The defaults are the analysis path of the card. The other values are the
JAX package's documented fallback configurations, which it reaches through
`BLISS_*` variables of the process; the port takes them as one explicit,
immutable argument of its entry points (`analyze_tensor`,
`analyze_samples`, `build_analyzer`, `analyze_batch`) and reads no such
variable.

- `timbral`: `"fft"` (default, `timbral_fft`: FFT-structured spectrum, the
  one that meets the flatness contract), `"flat"` (`timbral_flat`: the
  direct-DFT rows; mirrors `BLISS_TIMBRAL_FFT=0`), `"mags"`
  (`frame_dft_mags`, an FFT whose magnitudes reach device memory, then the
  descriptors from the `[F, 256]` magnitudes; mirrors
  `BLISS_TIMBRAL_FUSED=0`).
- `tempo`: `"fused"` (default, `specflux`), `"mags"` (`frame_dft_mags`
  then `onset_function`; mirrors `BLISS_TEMPO_FUSED=0`).
- `chroma_stft`: `"fused"` (default, `ct_stft_mags` frames the padded
  signal in the kernel), `"framed"` (`frame_signal_reflect` then
  `ct_frames_mags`; mirrors `BLISS_PALLAS_CT_FUSED=0`).
"""

from __future__ import annotations

import dataclasses

CHOICES = {
    "timbral": ("fft", "flat", "mags"),
    "tempo": ("fused", "mags"),
    "chroma_stft": ("fused", "framed"),
}


def check(kind: str, value: str) -> str:
    """`value` if it is a route of `kind`, else a ValueError."""
    if value not in CHOICES[kind]:
        raise ValueError(f"{kind} route {value!r}: one of {CHOICES[kind]}")
    return value


@dataclasses.dataclass(frozen=True)
class Routes:
    timbral: str = "fft"
    tempo: str = "fused"
    chroma_stft: str = "fused"

    def __post_init__(self):
        for field in dataclasses.fields(self):
            check(field.name, getattr(self, field.name))


DEFAULT = Routes()
