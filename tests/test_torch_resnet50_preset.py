"""``train_ddp``'s ResNet-50 preset in the port against the JAX package's
at the workload's default batch (64) and learning rate (1e-3).

The port's preset starts from JAX's initial weights (converted) and takes
two Adam steps on the fixed batch beside JAX's: the losses agree within
``PRESET_RTOL`` (float32 sums in another order through 50 layers).  At that
rate the loss rises after the first step in both, so the rise is the
preset's (small inputs, GroupNorm, Adam at 1e-3), not the port's.
"""

import numpy as np

from adapcc_tpu_torch.workloads import train_ddp

PRESET_RTOL = 2e-4


def test_resnet50_preset_follows_jax_at_the_default_lr():
    import jax
    import optax

    from adapcc_tpu.workloads.train_ddp import make_workload as jax_make_workload

    from adapcc_tpu_torch.ddp.trainer import adam
    from adapcc_tpu_torch.models.convert import flax_to_state_dict

    lr, batch, steps = 1e-3, 64, 2
    jax_loss, params, jax_batch = jax_make_workload("resnet50", batch, jax.random.PRNGKey(0))
    tx = optax.adam(lr)

    @jax.jit
    def jax_step(p, s, b):
        loss, g = jax.value_and_grad(jax_loss)(p, b)
        u, s = tx.update(g, s, p)
        return optax.apply_updates(p, u), s, loss

    loss_fn, model, batch_fn = train_ddp.make_workload("resnet50", batch, "cpu")
    model.load_state_dict(flax_to_state_dict(jax.device_get(params)))
    want, p, s = [], params, tx.init(params)
    for _ in range(steps):
        p, s, loss = jax_step(p, s, jax_batch())
        want.append(float(loss))
    got, opt = [], adam(lr)(model.parameters())
    for _ in range(steps):
        opt.zero_grad()
        loss = loss_fn(model, batch_fn())
        loss.backward()
        opt.step()
        got.append(loss.item())
    print(f"resnet50 preset, lr {lr}, batch {batch}: JAX losses {want}, port {got}")
    np.testing.assert_allclose(got, want, rtol=PRESET_RTOL)
    assert want[1] > 2 * want[0] and got[1] > 2 * got[0]
