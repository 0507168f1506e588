"""The Paddle ``Layer`` base class and its containers
(``paddle_tpu.nn.layer.layers`` counterpart).

A ``Parameter`` is a ``Tensor`` whose ``_value`` is a torch leaf;
``trainable`` flips its ``stop_gradient``. Parameters, sublayers and
buffers register on assignment, and ``state_dict`` names are the JAX
package's structured names (``blocks.0.attn.qkv.weight``). Writes that keep
a parameter's shape and dtype (``set_state_dict``, ``set_value``) go in
place, so an optimizer built over ``parameters()`` keeps training it;
``to``/``astype`` to another dtype or device rebind each parameter's
``_value`` to a new leaf, which the port's optimizers read at every
``step()``.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Iterator

import numpy as np
import torch

from paddle_tpu_torch.core.device import current_device
from paddle_tpu_torch.core.dtype import get_default_dtype, to_torch_dtype
from paddle_tpu_torch.core.tensor import Tensor, to_tensor

__all__ = ["Layer", "Parameter", "Sequential", "LayerList", "ParameterList",
           "LayerDict", "Identity"]


class Parameter(Tensor):
    """Trainable tensor (reference: EagerParamBase)."""

    def __init__(self, value, trainable: bool = True, name: str | None = None):
        if isinstance(value, Tensor):
            value = value._value
        super().__init__(value.detach(), stop_gradient=not trainable,
                         name=name)
        self.persistable = True

    @property
    def trainable(self):
        return not self.stop_gradient

    @trainable.setter
    def trainable(self, v):
        self.stop_gradient = not v

    def __repr__(self):
        return "Parameter " + super().__repr__()


def _retarget(t: Tensor, device=None, dtype=None):
    """Rebind t's value on `device` in `dtype` (floating values only),
    keeping a leaf's requires_grad."""
    v = t._value
    dt = dtype if dtype is not None and v.dtype.is_floating_point else v.dtype
    dev = v.device if device is None else device
    if dt == v.dtype and dev == v.device:
        return
    leaf = v.requires_grad and v.grad_fn is None
    t._value = v.detach().to(device=dev, dtype=dt).requires_grad_(leaf)


class Layer:
    def __init__(self, name_scope=None, dtype="float32"):
        object.__setattr__(self, "_parameters", OrderedDict())
        object.__setattr__(self, "_sub_layers", OrderedDict())
        object.__setattr__(self, "_buffers", OrderedDict())
        self._dtype = dtype
        self.training = True
        self._forward_pre_hooks: OrderedDict = OrderedDict()
        self._forward_post_hooks: OrderedDict = OrderedDict()

    # ---- registration -----------------------------------------------------
    def __setattr__(self, name, value):
        params = self.__dict__.get("_parameters")
        subs = self.__dict__.get("_sub_layers")
        if isinstance(value, Parameter):
            if params is None:
                raise RuntimeError("call Layer.__init__ before assigning "
                                   "parameters")
            params[name] = value
            self.__dict__.pop(name, None)
        elif isinstance(value, Layer):
            if subs is None:
                raise RuntimeError("call Layer.__init__ before assigning "
                                   "sublayers")
            subs[name] = value
            self.__dict__.pop(name, None)
        else:
            if params is not None and name in params:
                if value is None:
                    del params[name]
                else:
                    params[name] = value
                    return
            if subs is not None and name in subs and value is None:
                del subs[name]
                return
            object.__setattr__(self, name, value)

    def __getattr__(self, name):
        for store in ("_parameters", "_sub_layers", "_buffers"):
            d = self.__dict__.get(store)
            if d is not None and name in d:
                return d[name]
        raise AttributeError(f"'{type(self).__name__}' object has no "
                             f"attribute '{name}'")

    def __delattr__(self, name):
        for store in ("_parameters", "_sub_layers", "_buffers"):
            d = self.__dict__.get(store)
            if d is not None and name in d:
                del d[name]
                return
        object.__delattr__(self, name)

    # ---- parameter creation ----------------------------------------------
    def create_parameter(self, shape, attr=None, dtype=None, is_bias=False,
                         default_initializer=None):
        from paddle_tpu_torch.nn import initializer as I

        if attr is False:
            return None
        dtype = dtype or self._dtype or get_default_dtype()
        init = getattr(attr, "initializer", None)
        if init is None:
            init = default_initializer or (I.Constant(0.0) if is_bias
                                           else I.XavierUniform())
        return Parameter(init(shape, dtype),
                         trainable=getattr(attr, "trainable", True),
                         name=getattr(attr, "name", None))

    def add_parameter(self, name, parameter):
        self._parameters[name] = parameter
        return parameter

    def add_sublayer(self, name, sublayer):
        self._sub_layers[name] = sublayer
        return sublayer

    def register_buffer(self, name, tensor, persistable=True):
        if tensor is not None and not isinstance(tensor, Tensor):
            tensor = to_tensor(tensor)
        if tensor is not None:
            tensor.persistable = persistable
        self._buffers[name] = tensor
        return tensor

    # ---- traversal --------------------------------------------------------
    def named_sublayers(self, prefix="", include_self=False) -> Iterator:
        if include_self:
            yield prefix, self
        for name, sub in self._sub_layers.items():
            if sub is None:
                continue
            p = f"{prefix}.{name}" if prefix else name
            yield p, sub
            yield from sub.named_sublayers(prefix=p)

    def sublayers(self, include_self=False):
        return [l for _, l in self.named_sublayers(include_self=include_self)]

    def named_parameters(self, prefix="", include_sublayers=True) -> Iterator:
        seen = set()
        for name, p in self._parameters.items():
            if p is None or id(p) in seen:
                continue
            seen.add(id(p))
            yield (f"{prefix}.{name}" if prefix else name), p
        if include_sublayers:
            for lname, sub in self._sub_layers.items():
                if sub is None:
                    continue
                sp = f"{prefix}.{lname}" if prefix else lname
                for n, p in sub.named_parameters(prefix=sp):
                    if id(p) not in seen:
                        seen.add(id(p))
                        yield n, p

    def parameters(self, include_sublayers=True):
        return [p for _, p in self.named_parameters(
            include_sublayers=include_sublayers)]

    def named_buffers(self, prefix="", include_sublayers=True):
        for name, b in self._buffers.items():
            if b is not None:
                yield (f"{prefix}.{name}" if prefix else name), b
        if include_sublayers:
            for lname, sub in self._sub_layers.items():
                if sub is not None:
                    sp = f"{prefix}.{lname}" if prefix else lname
                    yield from sub.named_buffers(prefix=sp)

    def buffers(self, include_sublayers=True):
        return [b for _, b in self.named_buffers(
            include_sublayers=include_sublayers)]

    # ---- modes ------------------------------------------------------------
    def train(self):
        for l in self.sublayers(include_self=True):
            l.training = True
        return self

    def eval(self):
        for l in self.sublayers(include_self=True):
            l.training = False
        return self

    def apply(self, fn: Callable):
        for l in self.sublayers(include_self=True):
            fn(l)
        return self

    # ---- state dict -------------------------------------------------------
    def state_dict(self, destination=None, include_sublayers=True,
                   use_hook=True):
        out = destination if destination is not None else OrderedDict()
        for n, p in self.named_parameters(include_sublayers=include_sublayers):
            out[n] = p
        for n, b in self.named_buffers(include_sublayers=include_sublayers):
            if b.persistable:
                out[n] = b
        return out

    def set_state_dict(self, state_dict, use_structured_name=True):
        """Copy each entry (a Tensor, torch tensor or array) into the
        tensor of the same name, in place and in its dtype; returns
        (missing, unexpected) names. A shape mismatch raises."""
        own = self.state_dict()
        unexpected = [k for k in state_dict if k not in own]
        for k, v in state_dict.items():
            if k not in own:
                continue
            tgt = own[k]
            if isinstance(v, Tensor):
                v = v._value
            elif not isinstance(v, torch.Tensor):
                v = to_tensor(np.asarray(v), place=tgt.place)._value
            if tuple(v.shape) != tuple(tgt.shape):
                raise ValueError(f"shape mismatch for '{k}': "
                                 f"{tuple(v.shape)} vs {tuple(tgt.shape)}")
            tgt._set_value(v.detach().to(device=tgt._value.device,
                                         dtype=tgt._value.dtype))
        missing = [k for k in own if k not in state_dict]
        return missing, unexpected

    load_dict = set_state_dict

    def to(self, device=None, dtype=None, blocking=None):
        """Move every parameter and buffer to `device` and cast the
        floating ones to `dtype`."""
        dev = None if device is None else current_device(device)
        dt = to_torch_dtype(dtype)
        for t in self.parameters() + self.buffers():
            _retarget(t, dev, dt)
        return self

    def astype(self, dtype):
        return self.to(dtype=dtype)

    def float(self):
        return self.to(dtype="float32")

    def bfloat16(self):
        return self.to(dtype="bfloat16")

    # ---- hooks ------------------------------------------------------------
    def register_forward_pre_hook(self, hook):
        key = len(self._forward_pre_hooks)
        self._forward_pre_hooks[key] = hook
        return _HookHandle(self._forward_pre_hooks, key)

    def register_forward_post_hook(self, hook):
        key = len(self._forward_post_hooks)
        self._forward_post_hooks[key] = hook
        return _HookHandle(self._forward_post_hooks, key)

    # ---- call -------------------------------------------------------------
    def forward(self, *args, **kwargs):
        raise NotImplementedError

    def __call__(self, *args, **kwargs):
        for hook in self._forward_pre_hooks.values():
            res = hook(self, args)
            if res is not None:
                args = res if isinstance(res, tuple) else (res,)
        out = self.forward(*args, **kwargs)
        for hook in self._forward_post_hooks.values():
            res = hook(self, args, out)
            if res is not None:
                out = res
        return out

    def extra_repr(self):
        return ""

    def __repr__(self):
        lines = [f"{type(self).__name__}({self.extra_repr()}"]
        for name, sub in self._sub_layers.items():
            sub_repr = repr(sub).replace("\n", "\n  ")
            lines.append(f"  ({name}): {sub_repr}")
        return "\n".join(lines) + ")"

    def full_name(self):
        return type(self).__name__.lower()

    def children(self):
        return iter(self._sub_layers.values())

    def named_children(self):
        return iter(self._sub_layers.items())

    def clear_gradients(self):
        for p in self.parameters():
            p.clear_grad()


class _HookHandle:
    def __init__(self, store, key):
        self._store = store
        self._key = key

    def remove(self):
        self._store.pop(self._key, None)


class Sequential(Layer):
    def __init__(self, *layers):
        super().__init__()
        if (len(layers) == 1 and isinstance(layers[0], (list, tuple))):
            layers = layers[0]
        if len(layers) and isinstance(layers[0], tuple):
            for name, layer in layers:
                self.add_sublayer(str(name), layer)
        else:
            for i, layer in enumerate(layers):
                self.add_sublayer(str(i), layer)

    def forward(self, x):
        for layer in self._sub_layers.values():
            x = layer(x)
        return x

    def __getitem__(self, idx):
        vals = list(self._sub_layers.values())
        if isinstance(idx, slice):
            return Sequential(*vals[idx])
        return vals[idx]

    def __len__(self):
        return len(self._sub_layers)

    def __iter__(self):
        return iter(self._sub_layers.values())


class LayerList(Layer):
    def __init__(self, sublayers=None):
        super().__init__()
        for i, l in enumerate(sublayers or ()):
            self.add_sublayer(str(i), l)

    def append(self, layer):
        self.add_sublayer(str(len(self._sub_layers)), layer)
        return self

    def extend(self, layers):
        for l in layers:
            self.append(l)
        return self

    def insert(self, index, layer):
        vals = list(self._sub_layers.values())
        vals.insert(index, layer)
        self._sub_layers.clear()
        for i, l in enumerate(vals):
            self._sub_layers[str(i)] = l

    def __getitem__(self, idx):
        vals = list(self._sub_layers.values())
        if isinstance(idx, slice):
            return LayerList(vals[idx])
        return vals[idx]

    def __setitem__(self, idx, layer):
        self._sub_layers[str(idx)] = layer

    def __len__(self):
        return len(self._sub_layers)

    def __iter__(self):
        return iter(self._sub_layers.values())


class ParameterList(Layer):
    def __init__(self, parameters=None):
        super().__init__()
        for i, p in enumerate(parameters or ()):
            self.add_parameter(str(i), p)

    def append(self, parameter):
        self.add_parameter(str(len(self._parameters)), parameter)
        return self

    def __getitem__(self, idx):
        return list(self._parameters.values())[idx]

    def __len__(self):
        return len(self._parameters)

    def __iter__(self):
        return iter(self._parameters.values())


class LayerDict(Layer):
    def __init__(self, sublayers=None):
        super().__init__()
        if sublayers:
            items = (sublayers.items() if isinstance(sublayers, dict)
                     else sublayers)
            for k, v in items:
                self.add_sublayer(k, v)

    def __getitem__(self, key):
        return self._sub_layers[key]

    def __setitem__(self, key, layer):
        self.add_sublayer(key, layer)

    def __len__(self):
        return len(self._sub_layers)

    def keys(self):
        return self._sub_layers.keys()

    def items(self):
        return self._sub_layers.items()

    def values(self):
        return self._sub_layers.values()


class Identity(Layer):
    def forward(self, x):
        return x
