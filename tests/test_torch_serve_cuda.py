"""The port's serving path on the card against the CPU path, port against
port: every architecture at its reduced size (f32), the same weights on
both devices (mapped through ``interop.reference_tree`` and
``model_params_from``), greedy ``serve_batch``: every step's logits within
1e-4 * max|logit|, tokens equal wherever the CPU's top-2 margin exceeds
1e-3 * max|logit|, and a second call on the card gives the same tokens
bitwise.  Every test is marked ``cuda`` and skips where CUDA is
unavailable; this file imports torch and numpy only."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.interop import model_params_from, reference_tree  # noqa: E402
from repro_torch.launch import make_local_mesh, serve_batch  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

LOGIT_TOL, MARGIN = 1e-4, 1e-3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: checks the serving path on the card")
    return torch.device("cuda")


def _serve(cfg, model, prompts, frontend, gen_len):
    return serve_batch(cfg, make_local_mesh(device=model.device), prompts, gen_len,
                       frontend=frontend, model=model, keep_logits=True,
                       print_fn=lambda *_: None)


def tokens_agree(cpu_logits, cpu_tokens, card_tokens, scale):
    """Greedy tokens equal wherever the CPU's top-2 margin exceeds
    MARGIN * scale (a step's logits decide the next step's token)."""
    top2 = torch.topk(cpu_logits[:-1], 2, dim=-1).values  # (gen, B, 2)
    decided = ((top2[..., 0] - top2[..., 1]) > MARGIN * scale).numpy().T
    return bool((cpu_tokens == card_tokens)[decided].all())


@pytest.mark.cuda
@pytest.mark.parametrize("name", ARCHS)
def test_reduced_serve_on_the_card_matches_the_cpu(cuda, name):
    cfg = get_config(name).reduced()
    cpu = build_model(cfg, "cpu", seed=0)
    card = model_params_from(cfg, reference_tree(cpu), device=cuda)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    frontend = None
    if cfg.family in ("vlm", "audio"):
        frontend = rng.standard_normal((2, cfg.frontend_seq, cfg.frontend_dim)).astype(
            np.float32)
    a = _serve(cfg, cpu, prompts, frontend, 6)
    b = _serve(cfg, card, prompts, frontend, 6)
    scale = float(a["logits"].abs().max())
    assert float((a["logits"] - b["logits"]).abs().max()) < LOGIT_TOL * scale
    assert tokens_agree(a["logits"], a["tokens"], b["tokens"], scale)
    again = _serve(cfg, card, prompts, frontend, 6)
    np.testing.assert_array_equal(again["tokens"], b["tokens"])
    assert torch.equal(again["logits"], b["logits"])
