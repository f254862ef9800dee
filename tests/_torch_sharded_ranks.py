"""Rank bodies of the sharded LM and DeepFM tests (importable by the
spawned ranks of `repro_torch.launch.mesh.run_group`).

Every body takes the whole inputs (numpy: the reference's parameters and
batches), cuts its shard with `repro_torch.launch.shardings.shard_tree`,
runs the port's functions under the bound grid policy and returns numpy:
gathered logits, the rank's gradient and parameter shards, the MoE
layer's outputs and counts.
"""
import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.registry import ShapeSpec
from repro_torch.launch import shardings as sh
from repro_torch.train.loop import value_and_grad
from repro_torch.train.optimizer import adamw, data_parallel
from repro_torch.train.tree import tree_map

LR = 1e-3


def _np(tree):
    return tree_map(lambda t: t.detach().float().numpy() if isinstance(t, torch.Tensor) else t, tree)


def _torch(tree, dtype=None):
    return tree_map(lambda a: torch.from_numpy(np.array(a)).to(dtype or torch.from_numpy(np.array(a)).dtype), tree)


def _rows(policy, whole):
    """The rank's rows of a batch-major array whose batch splits over the data group."""
    n = whole.shape[0] // policy.n_data
    return whole[policy.data_index * n:(policy.data_index + 1) * n]


def lm_case(grid, case: dict) -> dict:
    from repro_torch.models import transformer_lm as lm
    from repro_torch.serve.scheduler import decode_multi_pos

    cfg, dtype = case["cfg"], case.get("dtype", torch.float32)
    policy = sh.lm_policy(grid, cfg)
    decode = case.get("decode")
    if decode is not None:
        shape = ShapeSpec("decode", "decode", seq_len=decode["cache_k"].shape[2], global_batch=decode["tokens"].shape[0])
        policy = dataclasses.replace(policy, cache=sh.cache_spec(cfg, shape, grid))
    policy = policy.bind()
    coords = grid.coords(dist.get_rank())
    full = _torch(case["params"], dtype)
    specs = sh.lm_param_specs(full, cfg, grid)
    params = sh.shard_tree(full, specs, coords)
    out = {"cache_spec": policy.cache}
    tokens = torch.from_numpy(_rows(policy, case["tokens"])).long()
    if case.get("prefill", True):
        with torch.no_grad():
            out["prefill"] = policy.model_gather(lm.lm_prefill(params, tokens[:, :-1], cfg, policy)).float().numpy()
    if case.get("grad", True):
        loss, grads = value_and_grad(lambda p, b: lm.lm_loss(p, b, cfg, policy), params, tokens)
        out["loss"] = float(loss)
        summed = tree_map(lambda g: policy.data_psum(g), grads)
        out["grads"] = _np(summed)
        opt = data_parallel(adamw(LR), policy, specs)
        new_params, _ = opt.update(grads, opt.init(params), params)
        out["adamw"] = _np(new_params)
    if decode is not None:
        cspec = policy.cache
        out["init_cache_shape"] = tuple(lm.lm_init_cache(cfg, decode["cache_k"].shape[1], decode["cache_k"].shape[2],
                                                         device="cpu", policy=policy)["k"].shape)
        tok_spec = sh.spec(sh.data_axes(grid)) if cspec[1] is not None else sh.spec(None)
        cut = lambda a: np.ascontiguousarray(a[sh.shard_slices(a.shape, cspec, coords)])
        toks = decode["tokens"]
        local_tok = lambda t: torch.from_numpy(np.ascontiguousarray(t[sh.shard_slices(t.shape, tok_spec, coords)]))
        with torch.no_grad():
            cache = {"k": torch.from_numpy(cut(decode["cache_k"])).to(dtype),
                     "v": torch.from_numpy(cut(decode["cache_v"])).to(dtype)}
            steps = []
            for i, pos in enumerate(decode["positions"]):
                logits, cache = lm.lm_decode_step(params, cache, local_tok(toks[:, i]), pos, cfg, policy)
                steps.append(policy.model_gather(logits).numpy())
            out["decode"] = np.stack(steps, 1)
            cache = {"k": torch.from_numpy(cut(decode["cache_k"])).to(dtype),
                     "v": torch.from_numpy(cut(decode["cache_v"])).to(dtype)}
            logits, _ = decode_multi_pos(params, cache, local_tok(toks[:, 0]),
                                         local_tok(np.asarray(decode["slot_positions"])), cfg, policy)
            out["multi_pos"] = policy.model_gather(logits).numpy()
    return out


def moe_case(grid, case: dict) -> dict:
    from repro_torch.nn import moe

    cfg = case["cfg"]
    policy = sh.lm_policy(grid, None).bind()
    coords = grid.coords(dist.get_rank())
    spec_of = {"router": sh.spec(None, None), "w_gate": sh.spec("model", None, None),
               "w_up": sh.spec("model", None, None), "w_down": sh.spec("model", None, None)}
    params = sh.shard_tree(_torch(case["params"]), spec_of, coords)
    x = torch.from_numpy(_rows(policy, case["x"]))
    moe.RECORD = []
    try:
        leaves = {k: v.requires_grad_(True) for k, v in params.items()}
        xg = x.clone().requires_grad_(True)
        y, aux = moe.moe_apply(leaves, xg, cfg, policy)
        dropped = int(moe.RECORD[0]["dropped"])
    finally:
        moe.RECORD = None
    cot = torch.from_numpy(_rows(policy, case["cotangent"]))
    grads = torch.autograd.grad((y * cot).sum() + aux, [*leaves.values(), xg])
    names = list(leaves)
    return {"y": y.detach().numpy(), "aux": float(aux), "dropped": dropped,
            "grads": {n: g.numpy() for n, g in zip(names, grads)}, "dx": grads[-1].numpy()}


def lm_group(rank: int, k: int, device: torch.device, job: dict) -> dict:
    torch.manual_seed(0)
    grid = job["grid"]
    out = {name: lm_case(grid, case) for name, case in job.get("lm", {}).items()}
    out.update({name: moe_case(grid, case) for name, case in job.get("moe", {}).items()})
    return out


def deepfm_group(rank: int, k: int, device: torch.device, job: dict) -> dict:
    from repro_torch.models import deepfm as fm

    grid, cfg = job["grid"], job["cfg"]
    policy = sh.recsys_policy(grid).bind()
    coords = grid.coords(dist.get_rank())
    full = _torch(job["params"])
    specs = sh.recsys_param_specs(full)
    params = sh.shard_tree(full, specs, coords)
    ids = torch.from_numpy(_rows(policy, job["ids"])).long()
    labels = torch.from_numpy(_rows(policy, job["labels"]))
    out = {}
    with torch.no_grad():
        out["forward"] = fm.deepfm_forward(params, ids, cfg, policy).numpy()
        cands = job["cands"]
        n = cands.shape[1] // policy.n_model
        mine = torch.from_numpy(np.ascontiguousarray(cands[:, policy.model_index * n:(policy.model_index + 1) * n]))
        scores = fm.deepfm_retrieval(params, torch.from_numpy(job["user"]).long(), mine.long(), cfg, policy)
        out["retrieval"] = policy.model_gather(scores, dim=1).numpy()
    x = torch.from_numpy(job["scatter"][dist.get_rank()]).requires_grad_()
    y = policy.model_reduce_scatter(x, dim=1)
    (y * torch.from_numpy(job["scatter_w"][dist.get_rank()][:, :y.shape[1]])).sum().backward()
    out["reduce_scatter"] = (y.detach().numpy(), x.grad.numpy())
    losses, state = [], None
    opt = data_parallel(adamw(LR), policy, specs)
    state = opt.init(params)
    for step in range(job["steps"]):
        loss, grads = value_and_grad(lambda p, b: fm.deepfm_loss(p, b[0], b[1], cfg, policy), params, (ids, labels))
        if step == 0:
            out["grads"] = _np(tree_map(lambda g: policy.data_psum(g), grads))
        params, state = opt.update(grads, state, params)
        losses.append(float(loss))
    out["losses"], out["params"] = losses, _np(params)
    return out
