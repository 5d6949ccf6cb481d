"""Sharded training on a mesh: gloo CPU ranks against the JAX package's
jitted single-device step.

One group of 4 gloo ranks (tests/torch_mesh_ranks.py, `train_cases`) runs
the training layout of parallel/sharding.py: each rank keeps its rows of
the batch over the data dims and its shard of every parameter and moment
(per JAX's `param_shardings`), the model gathers a layer's FSDP dims
where it uses them and runs tensor-parallel over the model dim (each
matmul on its column or row shard, the vocabulary-parallel head and
cross-entropy). The oracle is JAX on one device, in-process (JAX's own
mesh training legs need 8 host devices in a subprocess and do not pass
on every installation), at JAX's bounds: the loss within 1e-4 at every
step, and after the last step every parameter within 1e-4·max(1, max|p|)
and every first moment within 1e-4 of its leaf's largest (AdamW's update
and the global-norm clip do not change when one leaf's gradient is
scaled; the moment does). Cases: qwen3-8b SMOKE on data2×tp2 with fsdp "data"
(also with microbatches and an uneven MLM-style mask, and with
seq_shard_activations under remat "full"; and on pod2 × data2 with fsdp
"pod_data"; and on tp4, whose width does not divide its two KV heads:
the whole-head route), nemotron-4-15b SMOKE (squared ReLU), qwen1.5-110b
SMOKE (qkv biases, given values), qwen3-moe SMOKE with fsdp
"experts_data" (capacity factor 8: no drops; its oracle averages the
load-balance loss over the two data shards' rows, each shard routing its
own tokens, as a data-sharded MoE does), zamba2 and rwkv6 SMOKE, the
paper's encoder on sp2×tp2, and on tp4 with a vocabulary of 509 (no
padding), which splits unevenly (128, 128, 128, 125), and the internvl2
and musicgen frontends (patch and frame embeddings). The transformer-
family cases also run the prefill step, a prefill chunk and three
decode steps under the same layout against JAX's `forward`,
`prefill_chunk` and `decode_step` on each data shard's rows (the logits
gathered whole; the exact form: `forward` alone). No
op of a tensor-parallel train or prefill step outputs a tensor whose last
dim is the whole vocabulary over a batch row's tokens or more (no whole
LM head, no (tokens × V) logits),
and where the model width divides the KV heads no parameter is gathered
over the model dim. The compressed cross-pod step on pod2×data2
is held, step by step from the state the port's step starts from (its
parameters and residual), to JAX's `compressed_pod_reduce` of JAX's
gradients of each pod's rows: every element of the reduced gradient within
one code (the mean scale over the number of pods) of JAX's, the pods' mean
loss within 1e-4, and the loss within JAX's 5e-3 of the exact step over
three steps. The
Trainer runs the compressed step end to end with its residual checkpointed
in JAX's (n_pods, ...) layout and resumed; a JAX single-device checkpoint
resumes on data2×tp2, and that run's checkpoint resumes on one rank, each
within 1e-4 of JAX's own checkpoints of the same steps (elastic restart).
"""
import dataclasses
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.checkpoint import Checkpointer as JCheckpointer
from repro.configs import get_smoke_config
from repro.configs.base import OptimizerConfig, TrainConfig
from repro.models import model as jmodel
from repro.optim import adamw_init, adamw_update, clip_by_global_norm, \
    make_schedule
from repro.optim.grad_utils import quantize_int8
from repro.parallel.sharding import spec_for_path
from repro.train import Trainer as JTrainer
from repro.train.compressed_dp import compressed_pod_reduce
from repro.train.trainer import make_train_step

import torch_mesh_ranks

TOL = 1e-4
COMPRESSED_LOSS_TOL = 5e-3
# one code of the compressed reduction, plus what the pods' two fp32
# scales (max |g + residual| / 127 of gradients that agree to ~1e-6, not
# bit for bit) move a sum of up to 254 codes: 254 x 4e-6 of a code
CODE_SLACK = 1e-3
B, S = 8, 32
OCFG = dict(lr=1e-3, warmup_steps=0)
# the cases of the configs added with tensor parallelism run AdamW at eps
# 1e-3, as chip_smoke's parity legs do: at 1e-8 an element whose
# first-step gradient is ~1e-8 moves by ~lr on its sign alone, and that
# sign differs between the packages on one device already (nemotron's
# embed/tok: |g| < 1e-7, the port's gradients otherwise within 5.4e-7)
NEW_OPT = dict(eps=1e-3)
WIDTHS = {"data": 2, "model": 2}


def _smoke(arch, **kw):
    return dataclasses.replace(get_smoke_config(arch), dtype="float32", **kw)


CASES = {
    "dense": dict(cfg=_smoke("qwen3-8b"), mesh=(2,), fsdp="data",
                  batches="causal", params="dense", infer=True),
    "micro_mlm": dict(cfg=_smoke("qwen3-8b"), mesh=(2,), fsdp="data",
                      batches="uneven", params="dense", microbatch=4),
    "seq_shard": dict(cfg=_smoke("qwen3-8b", seq_shard_activations=True,
                                 remat="full"), mesh=(2,), fsdp="data",
                      batches="causal", params="dense", oracle="dense",
                      infer=True),
    "moe": dict(cfg=_smoke("qwen3-moe-30b-a3b"), mesh=(2,),
                fsdp="experts_data", batches="causal", params="moe",
                infer=True),
    "zamba": dict(cfg=_smoke("zamba2-1.2b"), mesh=(2,), fsdp="data",
                  batches="causal", params="zamba", infer=True),
    "rwkv": dict(cfg=_smoke("rwkv6-1.6b"), mesh=(2,), fsdp="data",
                 batches="causal", params="rwkv", infer=True),
    "zamba_tp4": dict(cfg=_smoke("zamba2-1.2b"), mesh=(4,), fsdp="data",
                      batches="causal", params="zamba", oracle="zamba",
                      infer=True),
    "rwkv_tp4": dict(cfg=_smoke("rwkv6-1.6b"), mesh=(4,), fsdp="data",
                     batches="causal", params="rwkv", oracle="rwkv",
                     infer=True),
    # width 48: three RWKV6 heads of the SMOKE head dim 16, which tp2
    # does not divide (the gathered route)
    "rwkv_whole": dict(cfg=_smoke("rwkv6-1.6b", d_model=48), mesh=(2,),
                       fsdp="data", batches="causal", params="rwkv_whole",
                       infer=True),
    # width 96: six heads of head dim 16 on tp2, where an fp32 WKV's
    # rounding left the 1e-4 bounds (models/rwkv6.py's docstring); AdamW
    # at eps 1e-3, as NEW_OPT says: at 1e-8 an fp32 run's first moments
    # after three steps sit ~1e-4 of a leaf's largest from fp64's, JAX's
    # 2.7e-4 at width 96 (scripts/rwkv_precision.py)
    "rwkv_w96": dict(cfg=_smoke("rwkv6-1.6b", d_model=96), mesh=(2,),
                     fsdp="data", batches="causal", params="rwkv_w96",
                     infer=True, opt=NEW_OPT),
    "encoder": dict(cfg=_smoke("linformer-paper"), mesh=(2, 2), fsdp="data",
                    batches="uneven", params="encoder", infer=True),
    "pod_data": dict(cfg=_smoke("qwen3-8b"), mesh=(2, 2, 1),
                     names=("pod", "data", "model"), fsdp="pod_data",
                     batches="causal", params="dense", oracle="dense"),
    "tp4_whole_heads": dict(cfg=_smoke("qwen3-8b"), mesh=(4,), fsdp="data",
                            batches="causal", params="dense",
                            oracle="dense", infer=True),
    "nemotron": dict(cfg=_smoke("nemotron-4-15b"), mesh=(2,), fsdp="data",
                     batches="causal", params="nemotron", infer=True,
                     opt=NEW_OPT),
    "qwen_bias": dict(cfg=_smoke("qwen1.5-110b"), mesh=(2,), fsdp="data",
                      batches="causal", params="qwen_bias", infer=True,
                      opt=NEW_OPT),
    "encoder_vocab": dict(cfg=_smoke("linformer-paper", vocab_size=509,
                                     vocab_pad_multiple=1),
                          mesh=(4,), fsdp="data", batches="uneven509",
                          params="encoder_vocab", infer=True, opt=NEW_OPT),
    "internvl": dict(cfg=_smoke("internvl2-2b"), mesh=(2,), fsdp="data",
                     batches="vlm", params="internvl", opt=NEW_OPT),
    "musicgen": dict(cfg=_smoke("musicgen-large"), mesh=(2,), fsdp="data",
                     batches="audio", params="musicgen", opt=NEW_OPT),
}
# the data shards of each mesh: the inference oracle runs JAX on each
# shard's rows (an MoE routes a shard's tokens together)
DATA_SHARDS = {(2,): 2, (4,): 1, (2, 2): 1, (2, 2, 1): 4}
MAX_SEQ = 64
CHUNK = 16               # a prefill chunk: one block of the SMOKE configs
DECODE_STEPS = 3


def _flat(tree):
    return {"/".join(str(p.key) if hasattr(p, "key") else str(p.idx)
                     for p in path): np.array(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _infer_inputs(vocab, seed=3):
    """The prefill step's tokens (B, S), a prefill chunk's (B, CHUNK; row
    1 with CHUNK / 2 valid) and the decode steps' (B, 3)."""
    rng = np.random.default_rng(seed)
    valid = np.full((B,), CHUNK, np.int32)
    valid[1] = CHUNK // 2
    return {"tokens": rng.integers(0, vocab, (B, S)).astype(np.int32),
            "chunk": rng.integers(0, vocab, (B, CHUNK)).astype(np.int32),
            "valid": valid,
            "feed": rng.integers(0, vocab, (B, DECODE_STEPS)).astype(
                np.int32)}


def _jax_infer(cfg, params, inputs, shards):
    """JAX's prefill logits (B, S, V), then (causal configs) the logits
    (B, V) of a prefill chunk (transformer families) and (B, 1, V) of each
    decode step, on each data shard's rows; and an ssm or hybrid config's
    prefill cache, flat, each leaf's rows (dim 1) of the shards joined."""
    causal = cfg.attention.kind != "linformer"
    recurrent = cfg.family in ("ssm", "hybrid")
    prefill = jax.jit(lambda p, t: jmodel.forward(
        p, cfg, {"tokens": t}, return_cache=causal, cache_max_seq=MAX_SEQ,
        cache_dtype=jnp.float32))
    chunk = jax.jit(lambda p, t, c, n: jmodel.prefill_chunk(
        p, cfg, {"tokens": t}, c, n))
    step = jax.jit(lambda p, t, c: jmodel.decode_step(p, cfg, {"tokens": t},
                                                      c))
    n = B // shards
    pre, chunks, dec, caches = [], [], [], []
    for i in range(shards):
        rows = slice(i * n, (i + 1) * n)
        logits, _, cache = prefill(params, jnp.asarray(
            inputs["tokens"][rows]))
        pre.append(np.asarray(logits))
        steps = []
        if recurrent:
            caches.append(_flat(cache))
        elif causal:
            lc, cache = chunk(params, jnp.asarray(inputs["chunk"][rows]),
                              cache, jnp.asarray(inputs["valid"][rows]))
            chunks.append(np.asarray(lc))
        if causal:
            for j in range(DECODE_STEPS):
                lt, cache = step(params, jnp.asarray(
                    inputs["feed"][rows, j:j + 1]), cache)
                steps.append(np.asarray(lt))
        dec.append(steps)
    joined = None if not caches else {
        k: (caches[0][k] if k == "length" else
            np.concatenate([c[k] for c in caches], axis=1))
        for k in caches[0]}
    return (np.concatenate(pre),
            np.concatenate(chunks) if chunks else None,
            [np.concatenate([d[j] for d in dec]) for j in range(len(dec[0]))],
            joined)


def _frontend_batches(cfg, n=2, seed=0):
    """Batches of a frontend config: internvl2's P patch embeddings before
    S - P text tokens, musicgen's S frame embeddings (labels over its
    vocabulary)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        P = cfg.frontend_embed_len
        labels = rng.integers(0, cfg.vocab_size, (B, S - P)).astype(np.int32)
        b = {"labels": labels, "loss_mask": np.ones_like(labels)}
        emb = (0.02 * rng.standard_normal((B, P or S, cfg.d_model))
               ).astype(np.float32)
        if cfg.embedding_inputs:
            b["embeds"] = emb
        else:
            b["tokens"], b["frontend_embeds"] = labels, emb
        out.append(b)
    return out


def _batches(vocab, uneven, n=2, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        toks = rng.integers(0, vocab, (B, S)).astype(np.int32)
        mask = ((rng.random((B, S)) < 0.3) if uneven
                else np.ones((B, S))).astype(np.int32)
        out.append({"tokens": toks, "labels": toks, "loss_mask": mask})
    return out


def _jax_run(step, params, opt, batches):
    losses, trail = [], []
    for b in batches:
        params, opt, m = step(params, opt, jax.tree.map(jnp.asarray, b))
        losses.append(float(m["loss"]))
        trail.append(_flat(params))
    return losses, trail, _flat(opt["mu"])


def _jax_steps(cfg, params, batches, microbatch=0, opt=None):
    ocfg = OptimizerConfig(**OCFG, **(opt or {}))
    step = jax.jit(make_train_step(cfg, ocfg, microbatch=microbatch))
    return _jax_run(step, params, adamw_init(params, ocfg), batches)


def _jax_moe_steps(cfg, params, batches):
    """JAX's step with the loss of a data2 MoE: the masked CE over the
    whole batch, the load-balance loss averaged over the two shards'
    forwards (each routes its own rows)."""
    ocfg = OptimizerConfig(**OCFG)
    sched = make_schedule(ocfg)

    def loss(p, b):
        nll = den = 0.0
        auxes = []
        for i in range(2):
            part = jax.tree.map(lambda x: x[i * B // 2:(i + 1) * B // 2], b)
            logits, aux, _ = jmodel.forward(p, cfg, part)
            n, d = jmodel.cross_entropy(
                logits, part["labels"], part["loss_mask"].astype(jnp.float32))
            nll, den = nll + n, den + d
            auxes.append(aux)
        ce = nll / jnp.maximum(den, 1.0)
        return ce + cfg.moe.aux_loss_weight * sum(auxes) / 2, ce

    @jax.jit
    def step(params, opt, b):
        (_, ce), g = jax.value_and_grad(loss, has_aux=True)(params, b)
        g, _ = clip_by_global_norm(g, ocfg.grad_clip)
        params, opt = adamw_update(g, opt, params, ocfg, sched(opt["step"]))
        return params, opt, {"loss": ce}

    return _jax_run(step, params, adamw_init(params, ocfg), batches)


def _unflat(flat, like):
    """A flat {path: array} as the pytree `like`."""
    paths = jax.tree_util.tree_flatten_with_path(like)
    keys = ["/".join(str(p.key) if hasattr(p, "key") else str(p.idx)
                     for p in path) for path, _ in paths[0]]
    return jax.tree_util.tree_unflatten(
        paths[1], [jnp.asarray(flat[k]) for k in keys])


def _jax_compressed(cfg, like, states, batches):
    """JAX's compressed reduction from each state the port's step started
    from (its whole parameters and its residual in the (n_pods, ...)
    layout): JAX's gradients of each pod's rows through
    compressed_pod_reduce. Returns, per step, the pods' mean loss, the
    reduced gradient and its one-code bound per leaf (the pods' mean scale
    over the number of pods)."""
    grad_fn = jax.jit(jax.value_and_grad(
        lambda p, b: jmodel.loss_fn(p, cfg, b)[0]))
    losses, reduced, bounds = [], [], []
    for (pflat, rflat), b in zip(states, batches):
        params, res = _unflat(pflat, like), _unflat(rflat, like)
        b = jax.tree.map(jnp.asarray, b)
        pods = [grad_fn(params, jax.tree.map(
            lambda x: x[i * B // 2:(i + 1) * B // 2], b)) for i in range(2)]
        losses.append(float(sum(lo for lo, _ in pods)) / 2)
        gp = jax.tree.map(lambda *x: jnp.stack(x), *(g for _, g in pods))
        tot = jax.tree.map(lambda g, r: g + r, gp, res)
        bounds.append({k: float(np.mean([quantize_int8(t[i])[1]
                                         for i in range(2)])) / 2
                       for k, t in _flat(tot).items()})
        reduced.append(_flat(compressed_pod_reduce(gp, res, 2)[0]))
    return losses, reduced, bounds


def _jax_trainer_ckpts(cfg, d):
    """JAX's single-device Trainer: 6 steps, checkpoints at 2, 4, 6."""
    tcfg = TrainConfig(seq_len=S, global_batch=B, steps=6, log_every=99,
                       checkpoint_every=2, checkpoint_dir=d,
                       optimizer=OptimizerConfig(lr=1e-3, warmup_steps=1,
                                                 total_steps=20))
    JTrainer(cfg, tcfg, log_fn=lambda s: None).run()


def _init(cfg):
    """Random weights of `cfg` as a JAX pytree: the port's seeded draw
    (JAX's tree structure from eval_shape, no JAX init compiled); qkv
    biases, zero at init, are given values."""
    from repro_torch.configs import config_from_dict
    from repro_torch.models import model as tmodel
    from repro_torch.models.transformer import flatten
    tp = tmodel.init_params(config_from_dict(dataclasses.asdict(cfg)),
                            seed=0, device="cpu")
    like = jax.eval_shape(lambda: jmodel.init_params(jax.random.PRNGKey(0),
                                                     cfg))
    rng = np.random.default_rng(1)
    flat = {k: v.numpy() for k, v in flatten(tp).items()}
    for k, v in flat.items():
        if k.split("/")[-1] in ("bq", "bk", "bv"):
            flat[k] = (0.1 * rng.standard_normal(v.shape)).astype(v.dtype)
    return _unflat(flat, like)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("train_mesh")
    params = {name: _init(c["cfg"])
              for name, c in CASES.items() if c["params"] == name}
    batches = {"causal": _batches(512, False, n=3),
               "uneven": _batches(512, True),
               "uneven509": _batches(509, True),
               "vlm": _frontend_batches(CASES["internvl"]["cfg"]),
               "audio": _frontend_batches(CASES["musicgen"]["cfg"])}
    infer = {"causal": _infer_inputs(512), "uneven": _infer_inputs(512),
             "uneven509": _infer_inputs(509)}
    payload = {
        "ocfg": OCFG, "batches": batches, "infer": infer,
        "max_seq": MAX_SEQ,
        "params": {k: _flat(v) for k, v in params.items()},
        "cases": {name: {**{k: v for k, v in c.items() if k != "oracle"},
                         "cfg": dataclasses.asdict(c["cfg"])}
                  for name, c in CASES.items()},
        "trainer_dir": str(base / "trainer"),
        "elastic_dir": str(base / "elastic")}
    os.makedirs(payload["elastic_dir"])
    finish = torch_mesh_ranks.start_ranks(base, "train_cases", payload)
    jdir = str(base / "jax_elastic")
    _jax_trainer_ckpts(CASES["dense"]["cfg"], jdir)
    shutil.copytree(os.path.join(jdir, "step_00000002"),
                    os.path.join(payload["elastic_dir"], "step_00000002"))
    open(os.path.join(payload["elastic_dir"], "ready"), "w").close()
    want = {}
    for name, c in CASES.items():
        if "oracle" in c:
            continue
        p, bs = params[c["params"]], batches[c["batches"]]
        want[name] = (_jax_moe_steps(c["cfg"], p, bs) if name == "moe" else
                      _jax_steps(c["cfg"], p, bs, c.get("microbatch", 0),
                                 c.get("opt")))
    for name, c in CASES.items():
        if c.get("infer"):
            key = (c.get("oracle", name), DATA_SHARDS[c["mesh"]])
            if key not in want:
                want[key] = _jax_infer(c["cfg"], params[c["params"]],
                                       infer[c["batches"]], key[1])
    ranks = finish()
    want["compressed"] = _jax_compressed(
        CASES["dense"]["cfg"], params["dense"],
        ranks[0]["compressed"]["states"], batches["causal"])
    return want, ranks, jdir, payload["elastic_dir"]


def _close(got, want, what):
    for k, w in want.items():
        err = np.abs(got[k] - w).max()
        assert err <= TOL * max(1.0, np.abs(w).max()), (what, k, err)


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_steps_match_jax(runs, case):
    want, ranks, _, _ = runs
    losses, trail, mu = want[CASES[case].get("oracle", case)]
    for got in ranks:
        res = got[case]
        assert len(res["losses"]) == len(losses)
        for s, (a, b) in enumerate(zip(res["losses"], losses)):
            assert abs(a - b) <= TOL, (case, s, a, b)
        assert res["losses"] == ranks[0][case]["losses"]
        _close(res["params"], trail[-1], case)
        # the first moment is linear in the gradients, so it shows a leaf's
        # gradient scale, which Adam's update and the clip do not: within
        # 1e-4 of each leaf's own largest moment
        for k, w in mu.items():
            err = np.abs(res["mu"][k] - w).max()
            assert err <= TOL * np.abs(w).max(), (case, "mu", k, err)


INFER = [name for name, c in CASES.items() if c.get("infer")]


@pytest.mark.parametrize("case", INFER)
def test_sharded_prefill_and_decode_match_jax(runs, case):
    """The prefill step's logits, those of a prefill chunk at an offset
    (one row half valid; transformer families) and of three decode steps
    under the training layout, gathered whole, against JAX's on each data
    shard's rows, and an ssm or hybrid config's prefill cache, gathered
    whole (its Mamba2/RWKV6 states held by heads over the model dim);
    under tensor parallelism the prefill's logits are this rank's
    vocabulary shard."""
    want, ranks, _, _ = runs
    c = CASES[case]
    pre, chunk, dec, cache = want[(c.get("oracle", case),
                                   DATA_SHARDS[c["mesh"]])]
    V = c["cfg"].padded_vocab_size
    for got in ranks:
        res = got[case]["infer"]
        _close({"prefill": res["prefill"]}, {"prefill": pre}, case)
        if chunk is not None:
            _close({"chunk": res["chunk"]}, {"chunk": chunk}, case)
        if cache is not None:
            assert set(res["cache"]) == set(cache), case
            _close(res["cache"], cache, case)
        assert len(res["decode"]) == len(dec)
        for s, (a, b) in enumerate(zip(res["decode"], dec)):
            _close({f"decode {s}": a}, {f"decode {s}": b}, case)
        tp = _tp(c)
        assert res["local_vocab"] in (-(-V // tp), V - (tp - 1) * -(-V // tp))


@pytest.mark.parametrize("case", [n for n, c in CASES.items()
                                  if c["mesh"] != (2, 2, 1)])
def test_tensor_parallel_steps_hold_no_whole_vocab(runs, case):
    """No op of a tensor-parallel train step (forward and backward) or
    prefill step outputs a tensor whose last dim is the whole vocabulary
    with a batch row's tokens or more before it: no rank holds a whole LM
    head or (tokens × V) logits."""
    _, ranks, _, _ = runs
    for got in ranks:
        assert got[case]["vocab_outputs"] == [], case
        if "infer" in got[case]:
            assert got[case]["infer"]["vocab_outputs"] == [], case


def _tp(c):
    return 4 if c["mesh"] == (4,) else 2


def _heads_split(c):
    """Whether an ssm or hybrid case runs its blocks on this rank's heads
    (the model width divides the Mamba2 / RWKV6 heads)."""
    cfg = c["cfg"]
    if cfg.family == "hybrid":
        heads = cfg.ssm.expand * cfg.d_model // cfg.ssm.head_dim
    else:
        heads = cfg.d_model // cfg.rwkv.head_dim
    return heads % _tp(c) == 0


def _ssm_model_gathers(c, phase):
    """The bytes one rank gathers over the model dim (comm's "gather" and
    "all_gather" ops: a gathered tensor's whole size, and the all-reduce
    of a gathered leaf's gradient) in a phase of an ssm or hybrid case
    on its heads. The train step and the prefill (B/shards × S ≥ D
    tokens a rank: sharding.column_matmul's weight route) gather the
    parameters ssm/w_in (and sum its gradient) and rwkv/cm_w_r, and the
    prefill the conv state's last W-1 inputs of x; the decode steps
    (B/shards rows < D: the activation route) gather no parameter, only
    each layer's w_in or cm_w_r output and Mamba2's new conv input of x,
    and the logits."""
    cfg = c["cfg"]
    rows = B // DATA_SHARDS[c["mesh"]]
    D, L, V, f = cfg.d_model, cfg.num_layers, cfg.padded_vocab_size, 4
    if cfg.family == "hybrid":
        d_inner = cfg.ssm.expand * D
        W = 2 * d_inner + 2 * cfg.ssm.state_dim + d_inner // cfg.ssm.head_dim
        per = {"train": 2 * D * W,
               "prefill": D * W + rows * (cfg.ssm.conv_width - 1) * d_inner,
               "decode": DECODE_STEPS * rows * (W + d_inner)}[phase]
    else:
        per = {"train": D * D, "prefill": D * D,
               "decode": DECODE_STEPS * rows * D}[phase]
    logits = DECODE_STEPS * rows * V if phase == "decode" else 0
    return (L * per + logits) * f


@pytest.mark.parametrize("case", [n for n, c in CASES.items()
                                  if c.get("infer")])
def test_no_parameter_is_gathered_over_the_model_dim(runs, case):
    """Where the model width divides the KV heads, a tensor-parallel step
    gathers no parameter over the model dim (`comm.OP_DIM_BYTES`): its
    model-dim traffic is all-reduces of activations (copy, reduce) and
    the cross-entropy's row maxima; with seq_shard_activations the stream
    is gathered and split over it too. On the whole-head route (tp4, two
    KV heads) wk/wv and q are gathered. The ssm and hybrid cases on their
    heads gather exactly `_ssm_model_gathers`: of the parameters only
    ssm/w_in and rwkv/cm_w_r, and those in the train step and the prefill
    alone (never ssm/w_out, rwkv/w_(r|k|v|g|o), cm_w_k or cm_w_v); on the
    gathered route (rwkv_whole: tp2 on three heads) their leaves are
    gathered whole, in decode too."""
    _, ranks, _, _ = runs
    c = CASES[case]
    cfg = c["cfg"]
    recurrent = cfg.family in ("ssm", "hybrid")
    whole_heads = (cfg.attention.num_kv_heads % _tp(c) != 0
                   and cfg.family != "ssm")
    for got in ranks:
        phases = {"train": got[case]["op_dim_bytes"],
                  "prefill": got[case]["infer"]["op_dim_bytes"]}
        if recurrent:
            phases["decode"] = got[case]["infer"]["decode_op_dim_bytes"]
        for phase, rec in phases.items():
            gathered = rec.get(("gather", "model"), 0) + \
                rec.get(("all_gather", "model"), 0)
            if recurrent and _heads_split(c):
                assert gathered == _ssm_model_gathers(c, phase), \
                    (case, phase, rec)
            elif whole_heads or cfg.seq_shard_activations or recurrent:
                assert gathered > 0, case
            else:
                assert gathered == 0, (case, rec)
            assert rec.get(("reduce", "model"), 0) > 0, case


def _fake_mesh(case):
    from repro_torch.launch import mesh as mesh_lib
    if case.get("names"):
        return mesh_lib.make_mesh(case["mesh"], case["names"],
                                  device_type="cpu")
    return mesh_lib.make_local_mesh(*case["mesh"], device_type="cpu")


@pytest.mark.parametrize("case", list(CASES))
def test_dry_run_counts_the_ranks_collective_bytes(runs, case):
    """The dry run of a case's step on a fake 4-rank world of the same mesh
    counts the bytes rank 0 moved in its first real step, op by op."""
    from repro_torch.configs import config_from_dict
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.parallel.sharding import ParallelCtx
    _, ranks, _, _ = runs
    c = CASES[case]
    cfg = config_from_dict(dataclasses.asdict(c["cfg"]))
    with mesh_lib.fake_world(4):
        ctx = ParallelCtx(mesh=_fake_mesh(c), fsdp=c["fsdp"])
        rec = dryrun.dry_run(cfg, ShapeConfig("mesh", S, B, "train"), ctx,
                             device="cpu",
                             microbatch=c.get("microbatch", 0))
    got = {op: v["bytes"] for op, v in rec["collectives"].items()}
    assert got == ranks[0][case]["bytes"]


def test_sharded_storage_is_jax_shard_shape(runs):
    """On data2×tp2 with fsdp "data" each rank stores exactly JAX's shard
    shape of every leaf and of its first moment."""
    want, ranks, _, _ = runs
    whole = {k: v.shape for k, v in want["dense"][1][-1].items()}
    for got in ranks:
        for key, shape in whole.items():
            spec = spec_for_path(key, ("data",), len(shape))
            local = tuple(
                n // int(np.prod([WIDTHS[a] for a in
                                  ((e,) if isinstance(e, str) else e or ())]))
                for n, e in zip(shape, tuple(spec) + (None,) * len(shape)))
            assert got["dense"]["local"][key] == local, key
            assert got["dense"]["mu_local"][key] == local, key
            assert got["elastic"]["local"][key] == local, key


def test_compressed_step_tracks_jax(runs):
    want, ranks, _, _ = runs
    exact = want["dense"][0]
    losses, reduced, bounds = want["compressed"]
    for got in ranks:
        res = got["compressed"]
        assert len(res["losses"]) == 3
        for s in range(3):
            assert abs(res["losses"][s] - exact[s]) < COMPRESSED_LOSS_TOL
            assert abs(res["losses"][s] - losses[s]) <= TOL
            for k, w in reduced[s].items():
                err = np.abs(res["reduced"][s][k] - w).max()
                assert err <= bounds[s][k] * (1 + CODE_SLACK), (s, k, err)


def test_trainer_compressed_pod_grads_end_to_end(runs):
    _, ranks, _, _ = runs
    for got in ranks:
        tc = got["trainer_compressed"]
        assert tc["compressed"] and tc["start"] == 6
        assert tc["loss2"] < 8.0 and tc["residual_same"]
        for shape in tc["saved_shapes"].values():
            assert shape[0] == 2


def _ckpt(d, step):
    out = {}
    for name in ("params", "opt_state"):
        with np.load(os.path.join(d, f"step_{step:08d}", f"{name}.npz")) \
                as z:
            out.update({f"{name}/{k}": z[k] for k in z.files})
    return out


def test_elastic_restart_one_to_four_and_back(runs):
    _, ranks, jdir, edir = runs
    assert all(r["elastic"]["start"] == 2 for r in ranks)
    assert ranks[0]["elastic"]["back_start"] == 4
    assert JCheckpointer(edir).latest_step() == 6
    for step in (4, 6):
        got, want = _ckpt(edir, step), _ckpt(jdir, step)
        assert set(got) == set(want)
        _close(got, want, f"step {step}")
