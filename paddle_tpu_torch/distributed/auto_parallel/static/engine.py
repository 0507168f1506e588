"""The auto-parallel ``Engine`` (``paddle_tpu.distributed.auto_parallel.
static.engine`` counterpart): ``fit``/``evaluate``/``predict`` loops over
a ``DistModel`` (the port's training step over the rank mesh), with the
JAX package's history, its one-shot-iterator warning and its batch
splitting, and ``save``/``load`` through ``framework.io_`` in the JAX
package's format. In a world of more than one rank each rank writes and
reads its own file, ``<path>_dist<rank>.pdparams`` (its parameters are
its shards); a world of one uses ``<path>.pdparams``, as there.
"""
from __future__ import annotations

import numpy as np

__all__ = ["Engine"]


def _file(path):
    from paddle_tpu_torch.distributed.env import get_rank, get_world_size

    if get_world_size() > 1:
        return f"{path}_dist{get_rank()}.pdparams"
    return path + ".pdparams"


class Engine:
    def __init__(self, model=None, loss=None, optimizer=None, metrics=None,
                 cluster=None, strategy=None):
        from paddle_tpu_torch.distributed.auto_parallel.api import DistModel

        self._model = model
        self._loss = loss
        self._optimizer = optimizer
        self._metrics = metrics if isinstance(metrics, (list, tuple)) else (
            [metrics] if metrics is not None else [])
        self._strategy = strategy
        self._dist = DistModel(model, None, loss, optimizer, strategy)
        self.history: dict[str, list] = {"loss": []}

    # -- loops ----------------------------------------------------------------
    def fit(self, train_data, valid_data=None, epochs=1, batch_size=None,
            steps_per_epoch=None, log_freq=10, verbose=1, callbacks=None,
            **kwargs):
        loader = self._as_loader(train_data, batch_size, epochs=epochs)
        for epoch in range(epochs):
            self._dist.train()  # per epoch: evaluate() flips the mode
            losses = []
            for step, batch in enumerate(loader):
                if steps_per_epoch is not None and step >= steps_per_epoch:
                    break
                loss = self._dist(*self._split_batch(batch))
                losses.append(float(loss))
                if verbose and log_freq and step % log_freq == 0:
                    print(f"epoch {epoch} step {step} loss {losses[-1]:.4f}")
            self.history["loss"].append(float(np.mean(losses)) if losses
                                        else None)
            if valid_data is not None:
                self.history.setdefault("val_loss", []).append(
                    self.evaluate(valid_data, batch_size=batch_size,
                                  verbose=0)["loss"])
        return self.history

    def evaluate(self, valid_data, batch_size=None, steps=None, verbose=1,
                 **kwargs):
        self._dist.eval()
        loader = self._as_loader(valid_data, batch_size)
        losses = []
        for step, batch in enumerate(loader):
            if steps is not None and step >= steps:
                break
            losses.append(float(self._dist(*self._split_batch(batch))))
        out = {"loss": float(np.mean(losses)) if losses else None}
        if verbose:
            print(f"eval loss {out['loss']}")
        return out

    def predict(self, test_data, batch_size=None, steps=None, **kwargs):
        self._dist.predict()
        loader = self._as_loader(test_data, batch_size)
        outs = []
        for step, batch in enumerate(loader):
            if steps is not None and step >= steps:
                break
            batch = batch if isinstance(batch, (list, tuple)) else [batch]
            outs.append(self._dist(*batch))
        return outs

    # -- save / load ---------------------------------------------------------
    def save(self, path, training=True):
        from paddle_tpu_torch.framework.io_ import save as _save

        state = {"model": self._dist.state_dict()}
        if training and self._optimizer is not None:
            state["optimizer"] = self._optimizer.state_dict()
        _save(state, _file(path))

    def load(self, path):
        from paddle_tpu_torch.framework.io_ import load as _load

        state = _load(_file(path))
        self._dist.set_state_dict(state["model"])
        if "optimizer" in state and self._optimizer is not None:
            self._optimizer.set_state_dict(state["optimizer"])

    # -- helpers -------------------------------------------------------------
    @staticmethod
    def _as_loader(data, batch_size, epochs=1):
        import warnings

        from paddle_tpu_torch.io import DataLoader, Dataset

        if isinstance(data, DataLoader):
            return data
        if isinstance(data, Dataset):
            return DataLoader(data, batch_size=batch_size or 1)
        if epochs > 1 and iter(data) is data:
            # a one-shot iterator over several epochs: materialised, so
            # later epochs see the batches
            warnings.warn("Engine.fit: materializing a one-shot iterator to "
                          "re-iterate it across epochs")
            return list(data)
        return data  # a re-iterable of batches

    @staticmethod
    def _split_batch(batch):
        if isinstance(batch, dict):
            return tuple(batch.values())
        if isinstance(batch, (list, tuple)):
            return tuple(batch)
        return (batch,)

    @property
    def main_program(self):
        return self._dist.dist_main_program()
