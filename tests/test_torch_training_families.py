"""One f32 train step of the vlm, audio, SSM and hybrid configs of
ARCH_IDS (reduced), as test_torch_training_step.py holds the decoder
configs: the loss, the metrics' keys and every gradient leaf against
``jax.grad`` of the reference's ``lm_loss`` on carried weights (the vlm
patch positions dropped from the loss, the audio encoder and
cross-attention differentiated), then a whole step moves the params. The
reference's SSD scan has a NaN gradient (ROADMAP C11); the SSM and
hybrid cases take it with ``tests/_torch_parity.py::finite_ssd_grad``,
which keeps its forward bit for bit."""
import pytest

torch = pytest.importorskip("torch")

from _torch_training import few_threads, step_parity  # noqa: E402,F401

ARCHS = ["phi-3-vision-4.2b", "seamless-m4t-large-v2", "mamba2-2.7b",
         "zamba2-1.2b"]


@pytest.mark.parametrize("arch", ARCHS)
def test_one_train_step_matches_reference(arch, tmp_path, monkeypatch):
    step_parity(arch, tmp_path, monkeypatch)
