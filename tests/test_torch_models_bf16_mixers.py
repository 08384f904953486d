"""bf16 parity of the hybrid (Hymba), SSM (Mamba-2) and audio (whisper)
architectures, as ``test_torch_models_bf16.py`` holds the others (same
weights, bounds and eager reference; split for the files' run time)."""
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.configs import ARCHS, get_config  # noqa: E402
from test_torch_models_bf16 import (MIXERS, bf16_reference_run,  # noqa: E402
                                    check_caches, check_logits)


@pytest.fixture(scope="module",
                params=[n for n in ARCHS if get_config(n).family in MIXERS])
def bf16_run(request):
    return bf16_reference_run(request.param)


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_bf16_logits_keep_dtype_and_match_reference(bf16_run, mode):
    check_logits(bf16_run, mode)


@pytest.mark.parametrize("stage", ["prefill_caches", "decode_caches"])
def test_bf16_caches_keep_dtype_and_match_reference(bf16_run, stage):
    check_caches(bf16_run, stage)
