"""TorchEstimator — Spark-style estimator over the port's torch frontend
(counterpart of ``horovod_tpu/spark/torch``).

Parity surface: ``horovod/spark/torch/estimator.py``
(``TorchEstimator``, ``TorchModel``) and ``.../torch/remote.py``
(``RemoteTrainer``): fit() ships (model, optimizer, loss) to every
rank, trains with the Horovod idiom — broadcast initial state, wrap
the optimizer, shard rows per rank — checkpoints through the Store,
and returns a TorchModel whose transform() runs the trained module.

Ranks are the port's launcher's worker processes on ``hvd.device()``
(the card unless the backend asks for the CPU): each moves the module
onto its device before the broadcast and the wrap (``.to`` keeps the
``Parameter`` objects the pickled optimizer refers to), copies its
shard to the device once, and reduces its gradients through
``horovod_tpu_torch.torch.DistributedOptimizer`` (NCCL, A1's grouped
passes a multi-tensor bucket).  The checkpoint and the returned
``state_dict`` are CPU copies, so the driver loads them without CUDA;
the trained module then goes to the device the fit ran on, where
``TorchModel.transform`` runs it.  Data arrives as the Store's
materialized npz (common.data), not Petastorm.
"""

from __future__ import annotations

import copy
import io
import json
import os
from typing import Any, Dict, List

from ..common.data import TRAIN_NPZ, VAL_NPZ, load_shard
from ..common.estimator import (
    HorovodEstimator,
    HorovodModel,
    resolve_compression,
)

CHECKPOINT_FILE = "checkpoint.pt"


def _epoch_batches(n: int, batch_size: int, n_batches: int, rng):
    """Exactly ``n_batches`` index batches from this rank's ``n`` rows,
    wrapping the (shuffled) permutation when n < n_batches*batch_size.

    The batch COUNT must be identical on every rank — each batch (or
    each ``backward_passes_per_step`` group) issues collective gradient
    allreduces, and strided shards differ by up to one row, which can
    otherwise flip ceil(n/batch) on one rank and deadlock the epoch.
    The count is therefore derived from the GLOBAL row count upstream,
    and wrapping keeps a short shard contributing full batches."""
    import numpy as np

    perm = rng.permutation(n) if rng is not None else np.arange(n)
    idxs = np.resize(perm, n_batches * batch_size)
    for s in range(n_batches):
        yield idxs[s * batch_size:(s + 1) * batch_size]


def _to_cpu(obj):
    """``obj`` with every tensor in it (dicts, lists, tuples) copied to
    the CPU: what the checkpoint and the driver's ``state_dict`` hold."""
    import torch

    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def _module_device(model):
    """The device of ``model``'s first parameter (or buffer); the CPU
    for a module that holds neither."""
    import itertools

    import torch

    first = next(itertools.chain(model.parameters(), model.buffers()), None)
    return torch.device("cpu") if first is None else first.device


def _torch_trainer(spec: Dict[str, Any]):
    """Per-rank training loop (reference: torch/remote.py
    RemoteTrainer.train) — module-level so the launcher channel pickles
    it by reference."""
    import numpy as np
    import torch

    import horovod_tpu_torch.torch as hvd
    from ..common.store import FilesystemStore

    hvd.init()
    device = hvd.device()
    p = spec["params"]
    seed = p.get("random_seed")
    if seed is not None:
        torch.manual_seed(seed + hvd.rank())
        np.random.seed(seed + hvd.rank())

    model, optimizer, loss_fns, metric_fns, transformation_fn = \
        spec["train"]
    # onto the device before the broadcast and the wrap: .to keeps the
    # Parameter objects, so the optimizer pickled with the model still
    # refers to them
    model.to(device)
    store = FilesystemStore(spec["store_prefix"])
    run_id = spec["run_id"]

    shard = load_shard(store.get_train_data_path(), TRAIN_NPZ,
                       hvd.rank(), hvd.size())
    val_shard = None
    # every rank must have val rows (rows[r::size] nonempty iff
    # r < n_val) or none may evaluate: the per-epoch val_loss
    # allreduce is collective
    if 0 < spec["n_val"] < hvd.size() and hvd.rank() == 0:
        import logging

        logging.getLogger("horovod_tpu_torch").warning(
            "validation disabled: %d validation rows cannot cover %d "
            "ranks (every rank needs >=1 row or the val_loss allreduce "
            "desyncs); grow the validation split or reduce num_proc",
            spec["n_val"], hvd.size())
    if spec["n_val"] >= hvd.size():
        val_shard = load_shard(store.get_val_data_path(), VAL_NPZ,
                               hvd.rank(), hvd.size())

    feature_cols = p["feature_cols"]
    label_cols = p["label_cols"]

    def tensors(cols, source):
        return [torch.from_numpy(np.ascontiguousarray(source[c]))
                for c in cols]

    def on_device(ts):
        return [t.to(device) for t in ts]

    features = tensors(feature_cols, shard)
    labels = tensors(label_cols, shard)
    # Sample weights (parity: sample_weight_col — the reference's
    # torch trainer passes the weight batch as the loss callable's
    # THIRD argument; loss fns must accept (output, label, weight))
    sw_col = p.get("sample_weight_col")
    weights = (torch.from_numpy(np.ascontiguousarray(
        shard[sw_col]).astype(np.float32)).to(device) if sw_col else None)
    # transformation_fn applies to the rank's (features, labels) at
    # data load, on the CPU tensors as the reference hands them — one
    # contract shared with the keras trainer, so the same hook behaves
    # identically under either estimator; training, per-epoch metrics
    # and validation all see the transformed data
    if transformation_fn is not None:
        features, labels = transformation_fn(features, labels)
    # one host-to-device copy of the shard; batches index it there
    features, labels = on_device(features), on_device(labels)
    val_features = val_labels = val_weights = None
    if val_shard is not None:
        val_features = tensors(feature_cols, val_shard)
        val_labels = tensors(label_cols, val_shard)
        if sw_col:
            val_weights = torch.from_numpy(np.ascontiguousarray(
                val_shard[sw_col]).astype(np.float32)).to(device)
        if transformation_fn is not None:
            val_features, val_labels = transformation_fn(
                val_features, val_labels)
        val_features = on_device(val_features)
        val_labels = on_device(val_labels)

    # Resume (parity: the reference estimator's checkpoint-resume on
    # refit): rank 0 loads the run's latest Store checkpoint; the
    # broadcast below propagates it to every rank.  Model AND
    # optimizer state resume, so momentum etc. continue seamlessly.
    if p.get("resume_from_checkpoint") and hvd.rank() == 0:
        ckpt_path = os.path.join(
            store.get_checkpoint_path(run_id), CHECKPOINT_FILE)
        if os.path.exists(ckpt_path):
            state = torch.load(ckpt_path, map_location=device,
                               weights_only=True)
            model.load_state_dict(state["model"])
            optimizer.load_state_dict(state["optimizer"])

    # Horovod idiom: everyone starts from rank 0's state, gradients
    # are averaged in the wrapped optimizer.
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    hvd.broadcast_optimizer_state(optimizer, root_rank=0)
    # bps derived ONCE: the optimizer's aggregation period and the
    # loop's step()/zero_grad() cadence must never diverge
    bps = p.get("backward_passes_per_step") or 1
    optimizer = hvd.DistributedOptimizer(
        optimizer, named_parameters=model.named_parameters(),
        compression=resolve_compression(
            hvd, p.get("gradient_compression") or p.get("compression")),
        backward_passes_per_step=bps)

    # per-output loss scaling (reference: loss_weights); None = 1.0
    loss_weights = p.get("loss_weights")
    if loss_weights is not None and len(loss_weights) != len(loss_fns):
        raise ValueError(
            f"loss_weights has {len(loss_weights)} entries for "
            f"{len(loss_fns)} loss function(s)")

    def forward_loss(feat_batch, label_batch, weight_batch=None):
        outputs = model(*feat_batch)
        if not isinstance(outputs, (tuple, list)):
            outputs = [outputs]
        losses = [
            fn(o, y) if weight_batch is None else fn(o, y, weight_batch)
            for fn, o, y in zip(loss_fns, outputs, label_batch)
        ]
        if loss_weights is not None:
            losses = [w * l for w, l in zip(loss_weights, losses)]
        return outputs, sum(losses)

    def averaged(value: float, name: str) -> float:
        # built on the rank's device: NCCL reduces no CPU tensor
        out = hvd.allreduce(torch.tensor([value], device=device),
                            name=name)
        return float(out[0])

    batch_size = p["batch_size"]
    n = len(features[0])
    if n == 0:
        raise ValueError(
            f"rank {hvd.rank()}'s training shard is empty "
            f"({spec['n_train']} rows over {hvd.size()} ranks); "
            "reduce num_proc or provide more data")
    # rank-CONSISTENT batch count from the global row count (see
    # _epoch_batches): every rank has at least n_train//size rows
    min_rows = max(1, spec["n_train"] // hvd.size())
    n_batches = -(-min_rows // batch_size)  # ceil
    if p.get("train_steps_per_epoch") is not None:
        n_batches = min(n_batches, p["train_steps_per_epoch"])
    # whole aggregation groups only: step() fires after exactly bps
    # backward passes; a cap below one group is a config error, not a
    # silent overrun of the user's explicit limit
    if n_batches < bps:
        raise ValueError(
            f"train_steps_per_epoch/row budget gives {n_batches} "
            f"batch(es) per epoch, fewer than "
            f"backward_passes_per_step={bps}: no optimizer step could "
            "ever fire")
    if n_batches % bps and hvd.rank() == 0:
        import logging

        logging.getLogger("horovod_tpu_torch").warning(
            "batches per epoch rounded %d -> %d to form whole "
            "backward_passes_per_step=%d groups",
            n_batches, n_batches // bps * bps, bps)
    n_batches = n_batches // bps * bps
    history: Dict[str, List[float]] = {"loss": []}
    ckpt_dir = store.get_checkpoint_path(run_id)

    for epoch in range(p["epochs"]):
        model.train()
        rng = (np.random.RandomState(
            (0 if seed is None else seed) * 1000 + epoch + hvd.rank())
            if p.get("shuffle", True) else None)
        epoch_loss, steps = 0.0, 0
        optimizer.zero_grad()
        for s, idx in enumerate(
                _epoch_batches(n, batch_size, n_batches, rng)):
            idx = torch.from_numpy(idx).to(device)
            fb = [f[idx] for f in features]
            lb = [y[idx] for y in labels]
            wb = weights[idx] if weights is not None else None
            _, loss = forward_loss(fb, lb, wb)
            loss.backward()
            if (s + 1) % bps == 0:
                optimizer.step()
                optimizer.zero_grad()
            epoch_loss += float(loss.detach())
            steps += 1
        # epoch metrics are averaged over ranks, like the reference's
        # metric averaging hooks
        history["loss"].append(
            averaged(epoch_loss / max(steps, 1), "epoch_loss"))
        if metric_fns:
            with torch.no_grad():
                outputs = model(*features)
            if not isinstance(outputs, (tuple, list)):
                outputs = [outputs]
            for i, mfn in enumerate(metric_fns):
                name = getattr(mfn, "__name__", f"metric_{i}")
                with torch.no_grad():
                    m = mfn(outputs[0] if len(outputs) == 1 else outputs,
                            labels[0] if len(labels) == 1 else labels)
                history.setdefault(name, []).append(
                    averaged(float(m), f"metric_{name}"))
        if val_features is not None:
            model.eval()
            with torch.no_grad():
                _, vloss = forward_loss(val_features, val_labels,
                                        val_weights)
            history.setdefault("val_loss", []).append(
                averaged(float(vloss), "val_loss"))
        if hvd.rank() == 0:
            os.makedirs(ckpt_dir, exist_ok=True)
            tmp = os.path.join(ckpt_dir, CHECKPOINT_FILE + ".tmp")
            torch.save(_to_cpu({"model": model.state_dict(),
                                "optimizer": optimizer.state_dict(),
                                "epoch": epoch}), tmp)
            os.replace(tmp, os.path.join(ckpt_dir, CHECKPOINT_FILE))

    result: Dict[str, Any] = {"history": history}
    if hvd.rank() == 0:
        store.write_text(
            os.path.join(store.get_logs_path(run_id), "history.json"),
            json.dumps(history))
        buf = io.BytesIO()
        torch.save(_to_cpu(model.state_dict()), buf)
        result["state_dict"] = buf.getvalue()
        result["device"] = str(device)
    hvd.shutdown()
    return result


class TorchEstimator(HorovodEstimator):
    """Reference-shaped params: ``model`` (nn.Module), ``optimizer``
    (constructed against the model's parameters, exactly as the
    reference requires), ``loss`` (callable or list matched to
    label_cols / multi-output models)."""

    _param_defs = {
        "optimizer": None,
        "input_shapes": None,   # accepted for source compat
        "backward_passes_per_step": 1,
    }

    def _check_params(self):
        super()._check_params()
        if self.getOptimizer() is None:
            raise ValueError(
                "optimizer param is required and must be constructed "
                "against the model's parameters "
                "(torch.optim.SGD(model.parameters(), ...))")
        if self.getLoss() is None:
            raise ValueError("loss param is required (callable or list)")
        if self.getSampleWeightCol() is not None:
            # weight batches ride the loss callable's THIRD argument
            # (reference contract); fail at fit() on the driver, not
            # with a confusing TypeError deep inside a worker rank
            import inspect

            loss = self.getLoss()
            fns = list(loss) if isinstance(loss, (list, tuple)) \
                else [loss]
            weight_names = {"weight", "weights", "sample_weight",
                            "sample_weights", "sw", "w"}
            for fn in fns:
                # nn.Module.__call__ is (*args, **kwargs): the real
                # arity lives on forward
                target = getattr(fn, "forward", fn)
                try:
                    sig = inspect.signature(target)
                except (TypeError, ValueError):
                    continue  # uninspectable callable: trust the user
                params = list(sig.parameters.values())
                if any(q.kind == q.VAR_POSITIONAL for q in params):
                    continue
                positional = [
                    q for q in params
                    if q.kind in (q.POSITIONAL_ONLY,
                                  q.POSITIONAL_OR_KEYWORD)]
                # the weight batch binds to the THIRD positional slot;
                # that slot must clearly be a weight: either required
                # (no default) or weight-named.  This rejects losses
                # like F.mse_loss, whose third slot is the defaulted
                # legacy `size_average` — the weight tensor would bind
                # there and crash (or silently train unweighted for a
                # defaulted `eps`-style third arg).
                third_ok = len(positional) >= 3 and (
                    positional[2].default is positional[2].empty
                    or positional[2].name.lower() in weight_names)
                if not third_ok:
                    raise ValueError(
                        f"sample_weight_col is set but loss "
                        f"{getattr(fn, '__name__', fn)!r} does not "
                        "take a sample-weight third argument — it "
                        "must accept (output, label, sample_weight) "
                        "with the third parameter required or named "
                        "like a weight")
                third = positional[2]
                if (third.default is third.empty
                        and third.name.lower() not in weight_names):
                    # A required third arg passes the gate, but a
                    # non-weight-looking name (focal's `gamma`, say)
                    # probably means the weight batch is about to bind
                    # to a hyperparameter and train silently wrong —
                    # say so, naming the parameter.  HVTPU_SPARK_STRICT
                    # upgrades the warning to a hard error for
                    # pipelines that would rather fail at fit() than
                    # risk a silently misweighted model.
                    msg = (
                        f"sample_weight_col is set and loss "
                        f"{getattr(fn, '__name__', fn)!r} will receive "
                        f"the per-sample weight batch as its third "
                        f"positional argument {third.name!r}, which "
                        "does not look like a weight parameter — if "
                        f"{third.name!r} is a hyperparameter, bind it "
                        "with functools.partial and accept "
                        "(output, label, sample_weight) instead")
                    strict = os.environ.get(
                        "HVTPU_SPARK_STRICT", "").lower()
                    if strict not in ("", "0", "false", "no"):
                        raise ValueError(
                            msg + " (raised because HVTPU_SPARK_STRICT "
                            "is set; unset it to downgrade this to a "
                            "warning)")
                    import warnings

                    warnings.warn(
                        msg + " (set HVTPU_SPARK_STRICT=1 to make this "
                        "an error)",
                        stacklevel=2)
        lw = self.getLossWeights()
        if lw is not None:
            loss = self.getLoss()
            n_fns = len(loss) if isinstance(loss, (list, tuple)) else 1
            if len(lw) != n_fns:
                raise ValueError(
                    f"loss_weights has {len(lw)} entries for {n_fns} "
                    "loss function(s)")

    def _serialize_training_spec(self) -> Dict[str, Any]:
        loss = self.getLoss()
        loss_fns = list(loss) if isinstance(loss, (list, tuple)) \
            else [loss]
        # one tuple, pickled with the spec in the launcher's single
        # pickle: the optimizer's parameter references stay identical
        # to the model's parameters after unpickling
        return {"train": (
            self.getModel(), self.getOptimizer(), loss_fns,
            list(self.getMetrics() or []), self.getTransformationFn())}

    def _remote_trainer(self):
        return _torch_trainer

    def _create_model(self, rank_results, run_id, store):
        import torch

        rank0 = next(r for r in rank_results if "state_dict" in r)
        trained = copy.deepcopy(self.getModel())
        trained.load_state_dict(
            torch.load(io.BytesIO(rank0["state_dict"]), weights_only=True))
        # transform runs where the fit ran: never quietly on the CPU
        # after a fit on the card
        trained.to(rank0["device"])
        trained.eval()
        return TorchModel(
            model=trained,
            feature_cols=list(self.getFeatureCols()),
            label_cols=list(self.getLabelCols()),
            output_cols=self.getOutputCols(),
            run_id=run_id, store=store,
            history=rank_results[0]["history"],
            batch_size=self.getBatchSize(),
        )


class TorchModel(HorovodModel):
    """The trained module's forward over a frame's feature columns, in
    batches of ``batch_size``, on the module's own device."""

    def _predict_columns(self, features):
        import numpy as np
        import torch

        model = self.getModel()
        model.eval()
        device = _module_device(model)
        # the frame stays on the host: each batch goes to the device
        # as it is used, so a frame larger than the card still predicts
        cols = [torch.from_numpy(np.ascontiguousarray(features[c]))
                for c in self.getFeatureCols()]
        outs: List[List[Any]] = None
        bs = self.getBatchSize()
        n = len(cols[0])
        with torch.no_grad():
            for lo in range(0, n, bs):
                batch = [c[lo:lo + bs].to(device) for c in cols]
                o = model(*batch)
                if not isinstance(o, (tuple, list)):
                    o = [o]
                if outs is None:
                    outs = [[] for _ in o]
                for acc, piece in zip(outs, o):
                    acc.append(piece.cpu().numpy())
        merged = [np.concatenate(a) for a in (outs or [])]
        # 1-col outputs flatten so they fit a DataFrame column; wider
        # outputs stay 2-D (object column on pandas assign)
        return [m.reshape(-1) if m.ndim == 2 and m.shape[1] == 1
                else (list(m) if m.ndim > 1 else m) for m in merged]
