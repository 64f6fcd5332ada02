"""The port's ``decode_forward`` in bfloat16 against the live JAX
package's, step by step, on the CPU: the smoke config of every family
the port registers, bfloat16 weights carried by ``params_from_jax``,
activations and K/V caches in bfloat16 and recurrent state in float32,
T = 24 steps (hymba's and gemma2's 16-slot rings wrap).  Each step's
logits and every cache leaf are held within :data:`BAR_BF16` of their
largest |value|; the archs of :data:`FOLLOW_ROUTING` route their MoE
rows as the reference does.
"""
import pytest

from test_torch_decode import ARCHS, _decode_lockstep

#: the whole-model bfloat16 bar of ``tests/test_torch_train.py``.  The
#: reference's own jitted bfloat16 decode stands up to 6.5e-2 off its
#: op-by-op run on xlstm (XLA keeps a fusion's intermediates in float32),
#: so the port, which rounds after every operation, is held against the
#: op-by-op run
BAR_BF16 = 6e-2


#: archs whose MoE rows follow the reference's expert choices
#: (``_FollowReferenceRouting``, flips only at a near-tie): deepseek-v2's
#: smoke router meets a 0.014 margin (of logits ~1) on lane 1 at step 6,
#: which one bf16 ulp of the hidden state crosses, and each routed
#: expert's output there outweighs the residual (fan-in E draws)
FOLLOW_ROUTING = ("deepseek-v2-236b",)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_forward_bf16_matches_jax_step_by_step(arch):
    _decode_lockstep(arch, "bfloat16", BAR_BF16, eager=True,
                     follow=arch in FOLLOW_ROUTING)
