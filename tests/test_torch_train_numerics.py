"""Why the port scrutinizes a training state with the loss in f32.

The reference's resume function runs the next step's loss in the config's
compute dtype.  In bf16, with more than one 512-position loss chunk, the
tied embedding's gradient sums one bf16 product per chunk, and where two
are exact negatives an element the loss reads gets a zero gradient in
every probe: the reference's AD scrutiny marks it uncritical, and a
scrutinized checkpoint drops a parameter the next step reads (ROADMAP
Queue 3).  Reduced recurrentgemma-2b with one RG-LRU layer, widened to
d_model 128 and vocab 4096, bf16 compute, B=1, T=1024, on the CPU: 14 of
the embedding's 524,288 elements come out uncritical in the reference.
The port's ``make_resume_fn`` runs the loss in f32 and marks every
parameter critical on the same state.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as r_get_config
from repro.core import scrutinize as r_scrutinize
from repro.data import pipeline as r_dp
from repro.models import init_params as r_init_params
from repro.train import optim as r_optim
from repro.train.step import make_train_step as r_make_train_step
from repro_torch import _tree, scrutinize
from repro_torch.configs import get_config
from repro_torch.convert import state_from_numpy
from repro_torch.launch import train as launch

# Small shapes: one intra-op thread each leaves the cores to the other
# test workers.
torch.set_num_threads(1)

WIDE = dict(dtype="bfloat16", vocab=4096, d_model=128, lru_dim=128,
            d_ff=256, n_layers=1)


def _map(fn, tree):
    named, treedef = _tree.flatten_with_names(tree)
    return _tree.unflatten(treedef, [fn(leaf) for _, leaf in named])


def test_bf16_loss_drops_embedding_elements_the_f32_resume_keeps():
    rcfg = dataclasses.replace(r_get_config("recurrentgemma-2b").reduced(),
                               **WIDE)
    r_oc = r_optim.OptConfig(kind="adamw", lr=3e-4, warmup=100,
                             clip_norm=1.0)
    r_step = jax.jit(r_make_train_step(rcfg, r_oc))
    params = jax.jit(lambda k: r_init_params(rcfg, k))(jax.random.PRNGKey(0))
    r_state = {"params": params, "opt": r_optim.init_opt(r_oc, params),
               "data": r_dp.init_state(rcfg, 1, 1024),
               "step": jnp.zeros((), jnp.int32)}

    def r_resume(s):
        b, _ = r_dp.next_batch(rcfg, s["data"])
        return {"loss": r_step(s["params"], s["opt"], b)[2]["loss"]}

    r_rep = r_scrutinize(r_resume, r_state)
    dropped = {n: l.total - l.critical for n, l in r_rep.leaves.items()
               if n.startswith("params/") and not l.all_critical}
    assert set(dropped) == {"params/embed"} and dropped["params/embed"] > 0

    np_state = _map(np.asarray, r_state)
    np_state["data"]["key"] = np_state["data"]["key"].astype(np.int32)
    cfg = dataclasses.replace(get_config("recurrentgemma-2b").reduced(),
                              **WIDE)
    rep = scrutinize(launch.make_resume_fn(cfg),
                     state_from_numpy(np_state, "cpu"), device="cpu")
    for name, leaf in rep.leaves.items():
        if name.startswith("params/"):
            assert leaf.all_critical, name
