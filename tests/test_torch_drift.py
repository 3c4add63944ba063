"""The accuracy contract on the card (counterpart of tests/test_tpu_drift.py):
the whole drift corpus at V2 and the V1 subset through the batch driver on
the card at f32, against the port's CPU f64 path on the same decoded
samples (bliss_tpu_torch/benches/drift.py), decoded by FallbackDecoder,
which every host can run (the audit compares two routes on one decode, so
the decoder does not change what it checks): at most 1e-4 per feature on
real content, at most 2e-2 and the same dominant chroma on the pure-tone
and dyad synthetics, and the same failures. Needs a card; run on the GPU
host with

    python3 -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_drift.py
"""

import pytest
import torch

from bliss_tpu_torch.benches import drift
from bliss_tpu_torch.io.fallback import FallbackDecoder


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_corpus_contract(cuda):
    result = drift.audit(drift.CORPUS, drift.V1_SUBSET, cuda, decoder=FallbackDecoder)
    assert result["ok"], "\n".join(result["failures"])
    # the corpus: 55 files and the CUE album's tracks; 22 degenerate
    # synthetics, so at least 34 real-content vectors carry the 1e-4 bound,
    # and all 8 files of the V1 subset
    assert result["v2"]["entries"] - result["v2"]["failed_on_both"] >= 55
    assert result["v2"]["real"] >= 34
    assert result["v1"]["real"] == 8
    assert result["v2"]["max_real"] <= 1e-4 and result["v1"]["max_real"] <= 1e-4
