"""Checkpoint/resume (numpy .npz) — aux-subsystem test.

The reference has no persistence at all (SURVEY §5, "Checkpoint /
resume: None" — it is an inference-only op library).  This framework's
training loop (examples/train_dit.py) checkpoints params + optimizer
state with ``utils.checkpoint`` and resumes from the latest step.  The test proves the
resume is *exact*: training N steps straight produces the same state as
training k steps, checkpointing, restoring into fresh buffers, and
training the remaining N-k.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from sageattention_jax.utils import checkpoint


def _make_problem():
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(0), 3)
    x = jax.random.normal(k1, (32, 16), jnp.float32)
    y = jax.random.normal(k2, (32, 4), jnp.float32)
    params = {
        "w": jax.random.normal(k3, (16, 4), jnp.float32) * 0.1,
        "b": jnp.zeros((4,), jnp.float32),
    }
    tx = optax.adamw(1e-2, weight_decay=0.01)

    def loss_fn(p):
        pred = x @ p["w"] + p["b"]
        return jnp.mean((pred - y) ** 2)

    @jax.jit
    def step(p, s):
        loss, grads = jax.value_and_grad(loss_fn)(p)
        updates, s = tx.update(grads, s, p)
        return optax.apply_updates(p, updates), s, loss

    return params, tx.init(params), step


class TestCheckpointResume:
    def test_resume_is_exact(self, tmp_path):
        total, cut = 6, 3
        params, opt_state, step = _make_problem()

        # straight run
        p_a, s_a = params, opt_state
        for _ in range(total):
            p_a, s_a, _ = step(p_a, s_a)

        # run to `cut`, checkpoint, restore into fresh buffers, finish
        ckpt = tmp_path / "ckpt"
        p_b, s_b = params, opt_state
        for i in range(cut):
            p_b, s_b, _ = step(p_b, s_b)
            checkpoint.save(ckpt, i, {"params": p_b, "opt_state": s_b})
        assert checkpoint.latest_step(ckpt) == cut - 1

        # fresh template (new process analogue) = init trees
        params2, opt_state2, _ = _make_problem()
        latest = checkpoint.latest_step(ckpt)
        assert latest == cut - 1
        restored = checkpoint.restore(
            ckpt, latest, {"params": params2, "opt_state": opt_state2}
        )
        p_c, s_c = restored["params"], restored["opt_state"]
        for _ in range(latest + 1, total):
            p_c, s_c, _ = step(p_c, s_c)

        jax.tree.map(
            lambda a, b: jnp.array_equal(a, b) or pytest.fail(
                "resumed run diverged from the straight run"),
            p_a, p_c,
        )
        # optimizer state resumes exactly too (count, mu, nu)
        jax.tree.map(
            lambda a, b: jnp.array_equal(a, b) or pytest.fail(
                "optimizer state diverged after resume"),
            s_a, s_c,
        )

    def test_max_to_keep_prunes(self, tmp_path):
        params, opt_state, step = _make_problem()
        ckpt = tmp_path / "ckpt"
        p, s = params, opt_state
        for i in range(5):
            p, s, _ = step(p, s)
            checkpoint.save(ckpt, i, {"params": p, "opt_state": s})
        assert checkpoint.latest_step(ckpt) == 4
        assert checkpoint.all_steps(ckpt) == [3, 4]

    def test_bf16_and_mismatch(self, tmp_path):
        """bf16 leaves round-trip bit-exactly; a template of another
        structure is refused."""
        tree = {"w": jnp.arange(6, dtype=jnp.bfloat16).reshape(2, 3) / 7,
                "n": jnp.int32(3)}
        checkpoint.save(tmp_path, 0, tree)
        back = checkpoint.restore(tmp_path, 0, tree)
        assert back["w"].dtype == jnp.bfloat16
        np.testing.assert_array_equal(np.asarray(back["w"], np.float32),
                                      np.asarray(tree["w"], np.float32))
        with pytest.raises(ValueError):
            checkpoint.restore(tmp_path, 0, {"w": tree["w"]})
