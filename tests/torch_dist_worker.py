"""One rank of the port's two-process data-parallel check
(tests/test_torch_distributed.py).

Started twice, as torchrun starts ranks (RANK, WORLD_SIZE, MASTER_ADDR,
MASTER_PORT in the environment), each joins a gloo process group on
localhost and runs every case of CASES in order: the seeded tiny model,
its share of the case's global batch (``parallel.input_pipeline.
local_batch``) and one ``make_train_step``.  Each rank writes
<out>/<case>_rank<r>.npz (the state dict after the step) and rank 0
<out>/results.json (loss, grad_norm per case, and whether
``make_global_batch`` of the ranks' shares gave the global batch back).

Usage: python tests/torch_dist_worker.py <out_dir>
"""
import json
import os
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from torch_dist_cases import CASES, case_config, global_batch  # noqa: E402


def main():
    out_dir = sys.argv[1]
    torch.set_num_threads(1)
    from rpg_ramnet_tpu_torch.models import ERGB2DepthRecurrent
    from rpg_ramnet_tpu_torch.parallel import distributed, make_global_batch
    from rpg_ramnet_tpu_torch.parallel.input_pipeline import local_batch
    from rpg_ramnet_tpu_torch.train.optim import make_optimizer
    from rpg_ramnet_tpu_torch.train.train_step import make_train_step

    distributed.init_from_env("gloo")
    r, w = distributed.rank(), distributed.world()
    results = {}
    try:
        for case in CASES:
            cfg = case_config(case)
            model = ERGB2DepthRecurrent(cfg.model)
            distributed.broadcast_module(model)
            step = make_train_step(cfg, model,
                                   make_optimizer(cfg, model.parameters()))
            mine = local_batch(global_batch(case), r, w,
                               cfg.trainer.grad_accum)
            aux = step({k: torch.from_numpy(np.ascontiguousarray(v))
                        for k, v in mine.items()})
            results[case] = {"loss": aux["loss"],
                             "grad_norm": aux["grad_norm"]}
            np.savez(os.path.join(out_dir, f"{case}_rank{r}.npz"),
                     **{k: v.numpy() for k, v in model.state_dict().items()})
        # the global batch again from the ranks' shares
        whole = global_batch("plain")
        regathered = make_global_batch({
            k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in local_batch(whole, r, w).items()})
        results["regathered"] = all(
            np.array_equal(regathered[k].numpy(), v) for k, v in whole.items())
    finally:
        distributed.destroy()
    if r == 0:
        regathered = results.pop("regathered")
        with open(os.path.join(out_dir, "results.json"), "w") as f:
            json.dump({"world": w, "cases": results,
                       "regathered": regathered}, f)


if __name__ == "__main__":
    main()
