"""Print the precision of the port's fp32 RWKV6 gradients at the four
shapes of tests/test_torch_rwkv_precision.py, on the CPU.

For each (width, head dim): the worst loss-gradient error of the port's
fp32 run and of JAX's, each against the port's fp64 run of the same code
(a share of the leaf's largest entry), and, after three AdamW steps (lr
1e-3, eps 1e-8, no warm-up) from the same weights on the same batches, the
largest difference of the first moments as a share of the reference
leaf's largest entry: the port's fp32 against JAX's, and each against the
port's fp64 steps. `--wkv-dtype float32` runs the port's fp32 time
mix in fp32 (`rwkv6.WKV_DTYPE[torch.float32]`), as before it ran in fp64.

    PYTHONPATH=src python scripts/rwkv_precision.py [--wkv-dtype float32]
"""
import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests"))
sys.path.insert(0, os.path.join(ROOT, "src"))


# the optimizer's modules, read in fp64 beside the model's for the fp64 steps
OPTIM_MODULES = ("repro_torch.optim.adamw", "repro_torch.optim.grad_utils",
                 "repro_torch.train.trainer")


def moment_spreads(width, head_dim, steps=3):
    """{"port-jax", "port-f64", "jax-f64": (the largest first-moment
    difference after `steps` steps as a share of the second one's largest
    entry, that leaf)}."""
    import contextlib
    import importlib
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch
    from repro.configs.base import OptimizerConfig as JOptimizerConfig
    from repro.optim import adamw as jadamw
    from repro.train import trainer as jtrainer
    from repro_torch.configs.base import OptimizerConfig
    from repro_torch.models.transformer import flatten
    from repro_torch.models import rwkv_model
    from repro_torch.optim import adamw_init
    from repro_torch.train import make_train_step
    import test_torch_rwkv_precision as prec

    @contextlib.contextmanager
    def f64_steps():
        mods = [importlib.import_module(m) for m in OPTIM_MODULES]
        saved = [m.torch for m in mods]
        for m in mods:
            m.torch = rwkv_model._Torch64("torch64")
        try:
            with rwkv_model.float64_reference():
                yield
        finally:
            for m, t in zip(mods, saved):
                m.torch = t

    def port_steps(dtype):
        pt = prec.port_params(flat, cfg_t, dtype)
        tstep = make_train_step(cfg_t, OptimizerConfig(**opt))
        tstate = adamw_init(pt, OptimizerConfig(**opt))
        for b in batches[:steps]:
            pt, tstate, _ = tstep(pt, tstate, {
                k: torch.from_numpy(np.array(v)) for k, v in b.items()})
        return {k: v.double().numpy()
                for k, v in flatten(tstate["mu"]).items()}

    cfg_j, params_j, cfg_t, flat, batches = prec.setup(width, head_dim)
    opt = dict(lr=1e-3, warmup_steps=0, eps=1e-8)
    jstep = jax.jit(jtrainer.make_train_step(cfg_j, JOptimizerConfig(**opt)))
    jstate = jadamw.adamw_init(params_j, JOptimizerConfig(**opt))
    pj = params_j
    for b in batches[:steps]:
        pj, jstate, _ = jstep(pj, jstate, {k: jnp.asarray(v)
                                           for k, v in b.items()})
    mu_j = {k: np.asarray(v, np.float64)
            for k, v in prec._flatten_j(jstate["mu"]).items()}
    mu_t = port_steps(torch.float32)
    with f64_steps():
        mu_64 = port_steps(torch.float64)
    return {"port-jax": prec.worst(mu_t, mu_j),
            "port-f64": prec.worst(mu_t, mu_64),
            "jax-f64": prec.worst(mu_j, mu_64)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--wkv-dtype", default="float64",
                    choices=("float64", "float32"))
    args = ap.parse_args(argv)
    import torch
    from repro_torch.models import rwkv6
    import test_torch_rwkv_precision as prec
    torch.set_num_threads(2)
    rwkv6.WKV_DTYPE[torch.float32] = getattr(torch, args.wkv_dtype)
    print(f"WKV dtype {args.wkv_dtype}")
    print("width, head dim | gradient error against port fp64: port fp32, "
          "JAX fp32 | first moments after 3 steps: port fp32 vs JAX, port "
          "fp32 vs port fp64, JAX vs port fp64 (leaf each)")
    for width, head_dim in prec.SHAPES:
        errs = prec.grad_errors(width, head_dim)
        mu = moment_spreads(width, head_dim)
        cols = [errs["port"], errs["jax"], mu["port-jax"], mu["port-f64"],
                mu["jax-f64"]]
        print(f"{width}, {head_dim} | " + " | ".join(
            f"{e:.3e} ({leaf})" for e, leaf in cols), flush=True)


if __name__ == "__main__":
    main()
