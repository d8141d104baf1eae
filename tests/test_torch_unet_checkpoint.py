"""The port's per-block activation checkpointing (models/unet.py,
``use_checkpoint`` + ``remat_policy``) on the CPU: with every policy the
training-mode UNet (dropout on, the same seed) gives the loss and the
gradients it gives without checkpointing, as
tests/test_training_convergence.py::test_remat_policies_grad_identical
holds the JAX package's ``rematted``; an unknown policy raises. Bars: loss
within 1e-6 relative, gradients within 1e-5 (the recomputation replays the
same dropout masks and the same fp32 ops).
"""

import numpy as np
import pytest
import torch

from tooncrafter_tpu_torch.models.unet import UNetModel
from tooncrafter_tpu_torch.utils.weights import init_random_

torch.set_num_threads(1)  # one thread a pytest worker: the suite runs six

KW = dict(model_channels=64, num_res_blocks=1, channel_mult=(1, 2),
          attention_resolutions=(1, 2), num_head_channels=32,
          context_dim=64, temporal_length=4)


def _loss_and_grads(unet, inputs):
    unet.train()
    torch.manual_seed(11)  # the dropout masks
    loss = unet(*inputs).square().mean()
    grads = torch.autograd.grad(loss, list(unet.parameters()),
                                allow_unused=True)
    return loss.item(), grads


@pytest.mark.parametrize("policy", [None, "dots", "dots_no_batch"])
def test_checkpoint_policies_keep_loss_and_gradients(policy):
    rng = np.random.default_rng(0)
    inputs = (torch.from_numpy(rng.normal(size=(1, 4, 4, 4, 8))
                               .astype(np.float32)),
              torch.tensor([321.0]),
              torch.from_numpy(rng.normal(size=(1, 77 + 64, 64))
                               .astype(np.float32)),
              torch.tensor([10.0]))
    base = UNetModel(**KW)
    init_random_(base, torch.Generator().manual_seed(0))
    ckpt = UNetModel(**KW, use_checkpoint=True, remat_policy=policy)
    ckpt.load_state_dict(base.state_dict())
    ref_loss, ref = _loss_and_grads(base, inputs)
    loss, got = _loss_and_grads(ckpt, inputs)
    assert loss == pytest.approx(ref_loss, rel=1e-6)
    for a, b in zip(got, ref):
        assert (a is None) == (b is None)
        if a is not None:
            torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


def test_unknown_policy_raises():
    with pytest.raises(ValueError, match="remat_policy"):
        UNetModel(**KW, use_checkpoint=True, remat_policy="everything")
