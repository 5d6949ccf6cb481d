"""Parity of the PyTorch port with the JAX package on the Mamba2 hybrid,
zamba2-1.2b SMOKE (family hybrid: 4 trunk layers, the shared attention +
MLP block after every 2, blockwise-causal Linformer with c = 16, r = 4 and
the layerwise-shared E), fp32, JAX weights bridged: the checks of
``test_torch_ssm_model.py`` (layout and checkpoints both ways, logits and
the prefill cache leaf by leaf, decode steps, ``decode_scan``, the static
serving fallback with JAX's tokens and its refusals, a train step with
every gradient leaf and the AdamW update), and both families' launchers
on the CPU.

The serve's prompts run every admission form of the block-256 family at
SMOKE size: whole blocks (16), whole blocks and remainder decode steps
(19, 40), and prompts shorter than a block (5), which decode every token.
Tolerances as in ``test_torch_ssm_model.py``."""
import pytest

from repro_torch.launch import serve as serve_launch
from repro_torch.launch import train as train_launch

from test_torch_ssm_model import (_one_torch_thread,  # noqa: F401
                                  check_decode_scan, check_decode_steps,
                                  check_fallback_refusals,
                                  check_forward_and_prefill_cache,
                                  check_param_layout_and_checkpoints,
                                  check_serve_static_fallback,
                                  check_train_step, family_setup)


@pytest.fixture(scope="module")
def setup():
    return family_setup("zamba2-1.2b", 48, (5, 19, 16, 40, 5, 19))


def test_param_layout_and_checkpoints_both_ways(setup, tmp_path):
    check_param_layout_and_checkpoints(setup, tmp_path)


def test_forward_logits_and_prefill_cache(setup):
    check_forward_and_prefill_cache(setup)


def test_decode_steps(setup):
    check_decode_steps(setup)


def test_decode_scan_tokens(setup):
    check_decode_scan(setup)


def test_serve_falls_back_to_static_with_jax_tokens(setup):
    check_serve_static_fallback(setup)


def test_fallback_refusals(setup):
    check_fallback_refusals(setup)


def test_train_step_matches_jax(setup):
    check_train_step(setup)


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "rwkv6-1.6b"])
def test_launchers_train_then_serve_the_checkpoint(arch, tmp_path, caplog):
    """launch/train.py takes a step of the --smoke config and saves it;
    launch/serve.py restores it, logs the fallback to the static
    scheduler and serves."""
    caplog.set_level("INFO")
    train_launch.main(["--arch", arch, "--smoke", "--device", "cpu",
                       "--steps", "1", "--seq", "32", "--batch", "2",
                       "--ckpt-dir", str(tmp_path)])
    outs = serve_launch.main(["--arch", arch, "--smoke", "--device", "cpu",
                              "--requests", "3", "--max-new-tokens", "4",
                              "--ckpt-dir", str(tmp_path / arch)])
    assert "restored step 1" in caplog.text
    assert "falling back to the static bucketed scheduler" in caplog.text
    assert "static: 3 requests" in caplog.text
    assert len(outs) == 3 and all(len(o) <= 4 for o in outs)
