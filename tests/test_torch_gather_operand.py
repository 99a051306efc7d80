"""The port's tiny kernel, gather and stages against the JAX gather-operand harness, rebuilt (interpret mode).

``benchmarks/exp_gather_operand.py`` asserts a TPU backend when imported
(``:25``), so nothing here imports it: its pieces are rebuilt by their lines.
``tiny_kernel`` (``:108-109``) runs in ``pl.pallas_call(...,
interpret=True)`` and the port's ``tiny`` (its plain version on the CPU) is
held bit-equal to it. ``g`` (``:30-31``) and the stages of phases 1-3
(``:82-129``) are rebuilt in jnp, with ``build_estep``'s E-step (``:49-79``)
as the JAX package's ``ops.likelihood.barcode_logits`` on the same calls,
and each stage's 6-step chain is held to the port's at 1e-6 relative, at a
small N_B and N_SLOTS. ``pmbc_estep`` at a small size is held to the port's
mainline E-step on the same operands, and to the JAX reference at the JAX
tests' oracle tolerance. The CUDA kernel against its plain version is in
tests/test_torch_gpu.py.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from demuxalot_tpu import sim as jsim
from demuxalot_tpu.ops import likelihood as JL
from demuxalot_tpu_torch.experiments import gather_operand as GO
from demuxalot_tpu_torch.ops.likelihood_kernel import estep_logits
from torch_problems import t

torch.set_num_threads(1)

N_B, N_SLOTS, N_S, CPB = 300, 5000, 200, 10
RTOL = 1e-6


def tiny_kernel(x_ref, o_ref):  # exp_gather_operand.py:108-109
    o_ref[:] = x_ref[:] * 2.0


def test_tiny_matches_tiny_kernel():
    x = np.random.RandomState(0).randn(*GO.TINY_SHAPE).astype(np.float32)
    theirs = pl.pallas_call(tiny_kernel, out_shape=jax.ShapeDtypeStruct(GO.TINY_SHAPE, jnp.float32),
                            interpret=True)(jnp.asarray(x))
    np.testing.assert_array_equal(GO.tiny(t(x)).numpy(), np.asarray(theirs))


def test_tiny_checks_its_input():
    with pytest.raises(ValueError, match="float32"):
        GO.tiny(torch.ones(8, 128, dtype=torch.float64))
    with pytest.raises(ValueError, match="contiguous"):
        GO.tiny(torch.ones(128, 8).T)
    with pytest.raises(ValueError, match="cpu or cuda"):
        GO.tiny(torch.ones(8, 128, device="meta"))


@pytest.fixture(scope="module")
def harness():
    """The small-size inputs for both sides and the jnp rebuild of build_estep's closure."""
    post, cb = GO.operand_inputs(N_B, N_SLOTS, "cpu")
    rng = np.random.default_rng(0)  # the file's draws (:26-28)
    np.testing.assert_array_equal(post.numpy(), rng.random((N_B, GO.PG), np.float32))
    np.testing.assert_array_equal(cb.numpy(), rng.integers(0, N_B, N_SLOTS).astype(np.int32))
    estep = GO.pmbc_estep("cpu", N_B, GO.N_D, N_S, CPB)
    betas, v2s, vid, cbv, q, _ = jsim.synthesize_device_workload(N_B, GO.N_D, N_S, CPB, seed=0)
    mixing, _names = JL.pseudogenotype_mixing([f"D{i:02}" for i in range(GO.N_D)], GO.DOUBLET_PRIOR)
    pen = JL.doublet_penalties(GO.N_D, GO.DOUBLET_PRIOR)
    gp = jnp.asarray(np.random.default_rng(1).random(betas.shape, np.float32))
    np.testing.assert_array_equal(np.asarray(gp), estep.genotype_prob.numpy())

    def jnp_estep(s):
        return JL.barcode_logits(gp * (1.0 + s * 1e-30), jnp.asarray(mixing), jnp.asarray(pen), jnp.asarray(vid),
                                 jnp.asarray(cbv), jnp.asarray(q), N_B)[:N_B, :mixing.shape[1]]

    return post, cb, estep, jnp.asarray(post.numpy()), jnp.asarray(cb.numpy()), jnp_estep


def _jnp_stages(phase, cb, estep):
    """The JAX file's stages (:82-129) in jnp; optimization_barrier as written."""
    n_d = GO.N_D

    def g(table_t):  # :30-31
        return jnp.sum(table_t[:, cb]) * 1e-30

    if phase == 1:
        return {
            "param+scalar": lambda c, a: g((a + c)[:, :n_d].T) + c,
            "fresh barrier": lambda c, a: g(jax.lax.optimization_barrier(a * (1.0 + c * 1e-30))[:, :n_d].T) + c,
            "fresh sliced": lambda c, a: g(jax.lax.optimization_barrier(a[:, :n_d] * (1.0 + c * 1e-30)).T) + c,
            "fresh softmax": lambda c, a: g(jax.nn.softmax(a + c * 1e-30, axis=-1)[:, :n_d].T) + c,
        }
    if phase == 2:
        return {
            "estep only": lambda c, a: jnp.sum(estep(c)) * 1e-30 + c,
            "estep+gather(indep post)": lambda c, a: jnp.sum(estep(c)) * 1e-30 + g((a + c * 1e-30)[:, :n_d].T) + c,
            "estep+gather(softmax)": lambda c, a: g(jax.nn.softmax(estep(c), axis=-1)[:, :n_d].T) + c,
        }
    tiny_in = jnp.ones(GO.TINY_SHAPE, jnp.float32)

    def tiny(s):
        return pl.pallas_call(tiny_kernel, out_shape=jax.ShapeDtypeStruct(GO.TINY_SHAPE, jnp.float32),
                              interpret=True)(tiny_in * (1.0 + s * 1e-30))

    def estep_sum(s):
        return jnp.sum(estep(s)) * 1e-30

    def gaz(c, a):
        return g((a + c * 1e-30)[:, :n_d].T)

    return {
        "gather alone": lambda c, a: gaz(c, a) + c,
        "gather THEN estep": lambda c, a: estep_sum(gaz(c, a) * 1e30 + c) + c,
        "tiny pallas + gather": lambda c, a: jnp.sum(tiny(c)) * 1e-30 + gaz(c, a) + c,
        "estep + 2 gathers": lambda c, a: estep_sum(c) + gaz(c, a) + gaz(c + 1e-12, a) + c,
    }


def test_g_matches_jnp(harness):
    post, cb, _, jpost, jcb, _ = harness
    theirs = float(jnp.sum(jpost[:, :GO.N_D].T[:, jcb]) * 1e-30)
    assert float(GO.g(post[:, :GO.N_D].T, cb)) == pytest.approx(theirs, rel=RTOL)


@pytest.mark.parametrize("phase", GO.PHASES)
def test_stages_match_jnp(harness, phase):
    """Each stage's chain of K = 6 steps (the file's fori_loop) against the jnp rebuild's."""
    post, cb, estep, jpost, jcb, jnp_estep = harness
    ours = GO.stages(phase, cb, estep)
    theirs = _jnp_stages(phase, jcb, jnp_estep)
    assert list(ours) == list(theirs)
    for name, step in ours.items():
        c = jnp.float32(0.0)
        for _ in range(GO.K):
            c = theirs[name](c, jpost)
        got = float(GO.chain(step, post))
        assert got == pytest.approx(float(c), rel=RTOL), name


def test_phases_need_the_estep():
    cb = torch.zeros(3, dtype=torch.int32)
    assert len(GO.stages(1, cb)) == 4
    with pytest.raises(ValueError, match="needs the E-step"):
        GO.stages(2, cb)
    with pytest.raises(ValueError, match="1, 2 or 3"):
        GO.stages(4, cb, estep=lambda s: s)


def test_pmbc_estep_is_the_mainline_estep(harness):
    _, _, estep, _, _, jnp_estep = harness
    zero = torch.zeros(())
    logits = estep(zero)
    assert tuple(logits.shape) == (N_B, GO.PG)
    assert torch.equal(logits, estep_logits(estep.genotype_prob, estep.operands))
    # and the JAX reference E-step on the same calls, at the JAX tests' oracle tolerance
    np.testing.assert_allclose(logits.numpy(), np.asarray(jnp_estep(jnp.float32(0.0))), rtol=1e-4, atol=5e-3)


@pytest.mark.parametrize("phase", GO.PHASES)
def test_entry_point_on_the_cpu(capsys, phase):
    assert GO.main(["--device", "cpu", "--phase", str(phase), "--n-b", str(N_B), "--n-slots", str(N_SLOTS),
                    "--n-snps", str(N_S), "--calls-per-barcode", str(CPB), "--repeats", "1"]) == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["phase"] == phase and result["device"] == "cpu"
    assert list(result["stages"]) == list(GO.stages(phase, torch.zeros(1, dtype=torch.int32), lambda s: s))
    assert all(np.isfinite(s["value"]) and s["ms"] > 0 for s in result["stages"].values())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            GO.main(["--phase", str(phase)])
