"""The port's training path on the card against the CPU path, port against
port: every architecture at its reduced size (f32) takes three train steps
from the same weights (mapped through ``interop.reference_tree`` and
``model_params_from``) on both devices, with every step's loss and the
first step's grad norm within 1e-4 relative (a later grad norm is not
held: Adam's sign-like first updates carry the devices' last-bit
differences into it, 3.4e-4 on Hymba's third step); a run stopped at step 10 and resumed from its checkpoint on
the card equals the straight run bitwise; and a bfloat16 model and its
optimizer state save and restore bitwise on the card.  Every test is
marked ``cuda`` and skips where CUDA is unavailable; this file imports
torch and numpy only."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.data import DataConfig, SyntheticLMData  # noqa: E402
from repro_torch.interop import (load_reference_tree, model_params_from,  # noqa: E402
                                 opt_state_from, reference_opt_state,
                                 reference_tree)
from repro_torch.launch import make_local_mesh, make_train_step, train_loop  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.runtime import CheckpointManager  # noqa: E402

CPU_RTOL = 1e-4  # card vs CPU, f32: losses, the first grad norm


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: checks the training path on the card")
    return torch.device("cuda")


def _tiny():
    cfg = get_config("llama3-8b").reduced()
    return dataclasses.replace(cfg, num_layers=2, d_model=64, num_heads=2,
                               num_kv_heads=2, head_dim=32, d_ff=128, vocab_size=128)


def _steps(cfg, model, device, n=3):
    bundle = make_train_step(cfg, make_local_mesh(device=device),
                             opt=AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=n))
    step_fn, opt_state = bundle.jit_for(None), bundle.init_opt(model)
    data = SyntheticLMData(DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                      global_batch=2))
    rng = np.random.default_rng(0)
    out = []
    for step in range(n):
        batch = data.batch(step)
        if cfg.family in ("vlm", "audio"):
            batch["frontend"] = rng.standard_normal(
                (2, cfg.frontend_seq, cfg.frontend_dim)).astype(np.float32)
        batch = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
        opt_state, metrics = step_fn(model, opt_state, batch)
        out.append((float(metrics["loss"]), float(metrics["grad_norm"])))
    return np.array(out)  # (steps, [loss, grad_norm])


@pytest.mark.cuda
@pytest.mark.parametrize("name", ARCHS)
def test_reduced_train_steps_on_the_card_match_the_cpu(cuda, name):
    cfg = get_config(name).reduced()
    cpu = build_model(cfg, "cpu", seed=0)
    card = model_params_from(cfg, reference_tree(cpu), device=cuda)
    a = _steps(cfg, cpu, "cpu")
    b = _steps(cfg, card, cuda)
    np.testing.assert_allclose(b[:, 0], a[:, 0], rtol=CPU_RTOL)
    np.testing.assert_allclose(b[0, 1], a[0, 1], rtol=CPU_RTOL)


@pytest.mark.cuda
def test_stop_and_resume_on_the_card_is_bitwise(cuda, tmp_path):
    cfg = _tiny()
    mesh = make_local_mesh(device=cuda)
    kw = dict(steps=20, batch=2, seq=16, lr=1e-3, log_every=100,
              print_fn=lambda *_: None)
    full = train_loop(cfg, mesh, **kw)
    train_loop(cfg, mesh, ckpt_dir=tmp_path, ckpt_every=10, stop_at=10, **kw)
    resumed = train_loop(cfg, mesh, ckpt_dir=tmp_path, resume=True, **kw)
    assert resumed["losses"] == full["losses"][10:]
    for (n, a), (_, b) in zip(full["model"].named_parameters(),
                              resumed["model"].named_parameters()):
        assert torch.equal(a, b), n


@pytest.mark.cuda
def test_bf16_checkpoint_round_trips_on_the_card(cuda, tmp_path):
    cfg = dataclasses.replace(get_config("llama3-8b").reduced(),
                              param_dtype="bfloat16", activation_dtype="bfloat16")
    model = build_model(cfg, cuda, seed=0)
    bundle = make_train_step(cfg, make_local_mesh(device=cuda))
    opt_state = bundle.init_opt(model)
    tokens = SyntheticLMData(DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                        global_batch=2)).batch(0)["tokens"]
    opt_state, _ = bundle.jit_for(None)(model, opt_state,
                                        {"tokens": torch.from_numpy(tokens).to(cuda)})
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, (reference_tree(model), reference_opt_state(model, opt_state)))
    fresh = build_model(cfg, cuda, seed=1)
    fresh_opt = bundle.init_opt(fresh)
    (params, ref_opt), step = mgr.restore(
        (reference_tree(fresh), reference_opt_state(fresh, fresh_opt)))
    load_reference_tree(fresh, params)
    restored_opt = opt_state_from(fresh, ref_opt)
    assert step == 1
    for (n, a), (_, b) in zip(model.named_parameters(), fresh.named_parameters()):
        assert a.dtype == b.dtype and b.device.type == "cuda"
        assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16 else a,
                           b.view(torch.int16) if b.dtype == torch.bfloat16 else b), n
    for part in ("m", "v"):
        for n, t in opt_state[part].items():
            assert torch.equal(t, restored_opt[part][n]), (part, n)
    assert int(restored_opt["step"]) == int(opt_state["step"]) == 1
