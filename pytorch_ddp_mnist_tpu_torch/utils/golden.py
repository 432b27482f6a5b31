"""The 10-epoch accuracy golden of the port (the port's counterpart of
`scripts/golden_accuracy.py`'s framework run and verdict, re-stated: the
port imports nothing of the JAX package).

`docs/golden_accuracy.json` holds the reference workload trained END TO
END: synthetic MNIST 60k/10k, batch 128, lr 0.01, 10 epochs, the initial
weights `build_reference_model(7)` (utils/torch_ref.py), the batch order of
`shared_batch_indices` (ShardedSampler, seed 42), by three runs of an
independent torch re-statement of the reference trainer (dropout seeds
1234, 5678, 91011) and by the JAX package's framework run. `train_port`
is the port's framework run: `make_run_fn(kernel, dtype, snapshots=True)`
with the threefry train key 1, then one eval over the per-epoch snapshots.
`verdict` holds a run against the file's torch runs with the JAX script's
formula: the accuracy gap to torch run A within max(NOISE_MULT x the torch
runs' spread, ACC_FLOOR, ACC_FLOOR_SAMPLES / test_n), and the final mean
val loss within LOSS_RATIO_BOUND of run A's, relatively. Dropout masks are
each side's own stream, so the gap is run-to-run mask noise.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import threefry
from ..parallel.sampler import ShardedSampler
from ..train.loop import make_snapshot_eval_step, val_summary
from ..train.scan import epoch_batch_indices, make_run_fn, resident_images

# the JAX script's thresholds (scripts/golden_accuracy.py:62-73)
NOISE_MULT = 3.0
ACC_FLOOR = 0.004
ACC_FLOOR_SAMPLES = 8.0
LOSS_RATIO_BOUND = 0.05


def shared_batch_indices(n_train: int, epochs: int, batch: int) -> np.ndarray:
    """(E, nbatches, batch) int32: the sampler order (seed 42, reshuffled
    per epoch) that the golden's runs share."""
    sampler = ShardedSampler(n_train, num_replicas=1, rank=0, shuffle=True,
                             seed=42)
    idxs = []
    for e in range(epochs):
        sampler.set_epoch(e)
        idxs.append(epoch_batch_indices(sampler, batch))
    return np.stack(idxs)


def train_port(params0, x_train_u8: np.ndarray, y_train: np.ndarray,
               idxs: np.ndarray, x_test: np.ndarray, y_test: np.ndarray,
               lr: float, device, *, kernel: str = "xla",
               dtype: str = "float32") -> dict:
    """The port's framework run on `device`: the whole run through
    make_run_fn (on a card one captured step a step) from `params0`, the
    threefry train key 1, then the eval of every epoch's params snapshot
    on the normalised test set. Returns the curve as the JAX script writes
    it ({"mean_val_loss", "accuracy"} an epoch) and the finals."""
    device = torch.device(device)
    run = make_run_fn(lr, dtype=dtype, kernel=kernel, snapshots=True)
    params = {n: {k: torch.as_tensor(v).to(device) for k, v in layer.items()}
              for n, layer in params0.items()}
    _, _, losses, (p_snaps, _) = run(
        params, threefry.key_data(1),
        torch.from_numpy(resident_images(x_train_u8)).to(device),
        torch.from_numpy(np.asarray(y_train, np.int32)).to(device), idxs)
    if not torch.isfinite(losses).all():
        raise RuntimeError("the golden run's training loss is not finite")
    per_sample, correct = make_snapshot_eval_step()(
        p_snaps, torch.as_tensor(np.asarray(x_test, np.float32), device=device),
        torch.as_tensor(np.asarray(y_test, np.int32), device=device))
    per_sample, correct = per_sample.cpu().numpy(), correct.cpu().numpy()
    curve = []
    for e in range(per_sample.shape[0]):
        _, mean_loss, acc = val_summary(per_sample[e], correct[e],
                                        batch_size=idxs.shape[-1])
        curve.append({"mean_val_loss": mean_loss, "accuracy": acc})
    return {"impl": "threefry2x32", "kernel": kernel, "dtype": dtype,
            "curve": curve, "final_accuracy": curve[-1]["accuracy"],
            "final_mean_val_loss": curve[-1]["mean_val_loss"]}


def verdict(run: dict, torch_runs: list, test_n: int) -> dict:
    """`run` against the golden's torch runs (run A first), by the JAX
    script's formula (scripts/golden_accuracy.py:214-221)."""
    accs = [r["final_accuracy"] for r in torch_runs]
    losses = [r["final_mean_val_loss"] for r in torch_runs]
    noise = max(accs) - min(accs)
    acc_bound = max(NOISE_MULT * noise, ACC_FLOOR, ACC_FLOOR_SAMPLES / test_n)
    acc_gap = abs(run["final_accuracy"] - accs[0])
    loss_ratio = abs(run["final_mean_val_loss"] - losses[0]) / max(losses[0],
                                                                  1e-9)
    return {"final_accuracy": run["final_accuracy"],
            "torch_final_accuracy": accs[0], "accuracy_gap": acc_gap,
            "torch_run_to_run_spread": noise, "accuracy_bound": acc_bound,
            "final_mean_val_loss": run["final_mean_val_loss"],
            "torch_final_mean_val_loss": losses[0],
            "val_loss_ratio_gap": loss_ratio,
            "val_loss_ratio_bound": LOSS_RATIO_BOUND,
            "pass": acc_gap <= acc_bound and loss_ratio <= LOSS_RATIO_BOUND}
