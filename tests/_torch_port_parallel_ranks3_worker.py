"""One rank of the port's three-rank CPU checks (3 gloo ranks).

``tests/test_torch_port_parallel_ranks3.py`` writes a job directory
(inputs as ``job.npz``, settings as ``job.json``, JAX-written
checkpoints) and starts :func:`run` in three processes with the ``spawn``
method. Rank 1 is a middle rank: it
sends and receives halos on both sides. Each rank joins a gloo group on
the CPU, runs the collectives and the port's sharded paths on the same
inputs and writes its results to ``rank<r>.npz``; rank 0 also runs the
single-device references. This module imports torch and the port only,
never JAX.
"""

import json
import os

import numpy as np
import torch


def _model(ckpt):
    from exaspim_tpu_torch.models import build_model
    from exaspim_tpu_torch.train.checkpoint import (
        load_checkpoint,
        params_from_flax,
    )

    c = load_checkpoint(ckpt)
    model = build_model(c["model_config"], dtype=torch.float32, device="cpu")
    model.load_state_dict(params_from_flax(c["params"]))
    return model, c["params"]


def _flat(model):
    return torch.cat([p.detach().reshape(-1)
                      for p in model.parameters()]).numpy()


def run(rank, world, port, job_dir):
    torch.set_num_threads(1)
    import torch.distributed as dist

    from exaspim_tpu_torch import parallel as par
    from exaspim_tpu_torch.inference import predict
    from exaspim_tpu_torch.ops.bm4d import bm4d
    from exaspim_tpu_torch.parallel._comm import (
        all_reduce_sum_,
        exchange_halos,
        gather_z,
    )
    from exaspim_tpu_torch.train.state import (
        create_train_state,
        make_train_step,
    )
    from exaspim_tpu_torch.transforms import build_transform

    with open(os.path.join(job_dir, "job.json")) as f:
        job = json.load(f)
    data = dict(np.load(os.path.join(job_dir, "job.npz")))
    out = {}
    assert par.initialize_multihost(f"127.0.0.1:{port}", world, rank,
                                    backend="gloo", device="cpu")
    mesh = par.make_mesh(axis="z", device="cpu")
    group = mesh.get_group("z")

    # The collectives on this rank's slab of a known tensor.
    whole = torch.from_numpy(data["whole"])
    core = whole.shape[0] // world
    slab = whole[rank * core:(rank + 1) * core]
    for halo in job["halos"]:
        above, below = exchange_halos(slab, halo, group)
        out[f"above_{halo}"], out[f"below_{halo}"] = above.numpy(), \
            below.numpy()
    out["gathered"] = gather_z(slab, group).numpy()
    out["summed"] = all_reduce_sum_(slab * (rank + 1), group).numpy()

    # Sharded predict, both stitch branches, uint16 and float, against one
    # predict.
    model, _ = _model(job["predict_ckpt"])
    t = build_transform(job["tcfg"])
    img = data["img"]
    for name, kw in job["predict"].items():
        for ret in (False, True):
            key = f"{name}_{'float' if ret else 'u16'}"
            out[f"sharded_{key}"] = par.predict_sharded(
                img, model, t, mesh, return_float=ret, **kw)
            if rank == 0:
                out[f"single_{key}"] = predict(img, model, t, device="cpu",
                                               return_float=ret, **kw)

    # Sharded BM4D against BM4D of the reflect-extended volume.
    vol, b = data["bm4d_vol"], job["bm4d"]
    for matcher in ("kernel", "dense"):
        out[f"bm4d_{matcher}"] = par.bm4d_sharded(
            vol, b["sigma"], mesh, search=b["search"],
            matcher=matcher).numpy()
    if rank == 0:
        halo = par.bm4d_halo(search=b["search"])
        ext = np.pad(vol, ((halo, halo), (0, 0), (0, 0)), mode="reflect")
        out["bm4d_oracle"] = bm4d(ext, b["sigma"], search=b["search"],
                                  device="cpu")[halo:-halo].numpy()

    # One data-parallel step on this rank's share against one step of the
    # whole batch, from the same weights.
    dmesh = par.make_mesh(axis="data", device="cpu")
    d = job["dp"]
    x, y, fg = (torch.from_numpy(data[k]) for k in ("dp_x", "dp_y", "dp_fg"))
    dp_model, params = _model(job["ckpt"])
    state = create_train_state(dp_model, lr=d["lr"],
                               total_steps=d["total_steps"], params=params)
    step = par.make_dp_train_step(dmesh, fg_weight=d["fg_weight"])
    apply, grads = state.apply_gradients, []

    def spy():  # the all-reduced gradient AdamW receives
        grads.extend(p.grad.reshape(-1).clone()
                     for p in dp_model.parameters())
        return apply()

    state.apply_gradients = spy
    share = par.shard_batch(dmesh, (x, y, fg))
    out["dp_share"] = np.array(share[0].shape[0])
    state, loss = step(state, *share)
    out["dp_loss"], out["dp_params"] = loss.numpy(), _flat(dp_model)
    out["dp_grads"] = torch.cat(grads).numpy()
    if rank == 0:
        one, _ = _model(job["ckpt"])
        st = create_train_state(one, lr=d["lr"], total_steps=d["total_steps"],
                                params=params)
        one_grads, one_apply = [], st.apply_gradients

        def one_spy():
            one_grads.extend(p.grad.reshape(-1).clone()
                             for p in one.parameters())
            return one_apply()

        st.apply_gradients = one_spy
        st, l1 = make_train_step(fg_weight=d["fg_weight"])(st, x, y, fg)
        out["single_loss"], out["single_params"] = l1.numpy(), _flat(one)
        out["single_grads"] = torch.cat(one_grads).numpy()

    np.savez(os.path.join(job_dir, f"rank{rank}.npz"), **out)
    dist.barrier()
    dist.destroy_process_group()
