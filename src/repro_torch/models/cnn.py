"""The paper's evaluation models (Section 4.1) in PyTorch, functional.

Counterpart of the reference's ``models/cnn.py``:

* SimpleCNN — 3 conv (32/64/64, 3x3) + FC(64) + softmax head; 122,570
  params at 16x16x3;
* LeNet5    — 6/16 conv (5x5) + 120/84 FC;
* VGG11     — conv 64-128-256x2-512x4 + FC head (CIFAR variant);
* ResNet18  — basic blocks with GroupNorm (the standard substitute for
  batch norm under FL aggregation).

Layouts (the reference's are NHWC/HWIO):

* models take NHWC images, as the dataset holds them, and copy them to
  contiguous NCHW on entry (see ``_nchw``), so ``F.conv2d`` runs on them;
* conv weights are OIHW; ``interop.cnn_params_from_jax`` converts;
* feature maps are NCHW (``feature_maps``), and ``pruning.
  feature_map_scores`` reads the channel axis at 1;
* ``fc1``, which consumes the last flattened feature map, keeps the
  reference's ``[spatial, C, out]`` weight with NHWC's spatial index
  ``h * W + w``, so a channel prune is one axis-1 slice.

``apply`` infers every width from the parameter shapes, so a shrunk tree
runs through the same code.  ``apply(..., masks=)`` takes FedAP's per-layer
filter masks (``pruning.filter_masks``): a masked layer's feature maps are
zeroed after its activation, and a masked dense layer goes through
``layers.masked_dense`` (bias, then mask), which runs the ``masked_matmul``
kernel only for 128-aligned widths.  No registered model reaches it:
SimpleCNN never prunes ``fc1``, LeNet5's 120 and 84 are unaligned, VGG11
and ResNet18 have no masked dense layer.

Convolutions and pools are ``F.conv2d`` and ``F.max_pool2d``, GroupNorm
plain tensor ops: the reference runs them as plain XLA, outside any Pallas
kernel.  Every model takes ``device=`` (default ``"cuda"``, which raises
when CUDA is missing).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch import device as _device
from repro_torch.core.pruning import CoupledParam, PrunableLayer, PruneSpec
from repro_torch.models.layers import masked_dense


# ---------------------------------------------------------------------------
# primitives (NCHW activations, OIHW weights)
# ---------------------------------------------------------------------------

def same_padding(size: int, k: int, stride: int) -> tuple[int, int]:
    """XLA's SAME padding of one spatial dim: the output holds
    ``ceil(size / stride)`` positions and the total padding splits as
    ``lo = total // 2``, ``hi = total - lo`` (so a stride-2 3x3 conv on an
    even size pads (0, 1))."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv2d(x, w, b=None, *, stride: int = 1):
    """SAME convolution of ``x`` [B, C, H, W] with ``w`` [O, C, kh, kw]."""
    (ht, hb), (wl, wr) = (same_padding(x.shape[2], w.shape[2], stride),
                          same_padding(x.shape[3], w.shape[3], stride))
    if ht == hb and wl == wr:
        return F.conv2d(x, w, b, stride=stride, padding=(ht, wl))
    return F.conv2d(F.pad(x, (wl, wr, ht, hb)), w, b, stride=stride)


def max_pool(x, size: int = 2, stride: int = 2):
    """SAME max pooling: an odd edge is padded with -inf at its end."""
    (ht, hb), (wl, wr) = (same_padding(x.shape[2], size, stride),
                          same_padding(x.shape[3], size, stride))
    if ht or hb or wl or wr:
        x = F.pad(x, (wl, wr, ht, hb), value=-math.inf)
    return F.max_pool2d(x, size, stride)


def avg_pool_global(x):
    return x.mean(dim=(2, 3))


def group_norm(x, scale, bias, groups: int = 8, eps: float = 1e-5):
    """GroupNorm over ``gcd(groups, C)`` groups, as the reference computes
    it: the mean, then the population variance as the mean of the squared
    deviations (two passes; ``F.group_norm`` on the CPU forms it in one
    pass, which loses the small variances of ResNet18's 1x1 last stage when
    FedAP zeroes most of a group), then ``(x - mean) / sqrt(var + eps)``.
    The group count follows the channel count, so a shrunk ``gn1`` may
    have fewer groups."""
    b, c, h, w = x.shape
    g = math.gcd(groups, c)
    xg = x.reshape(b, g, c // g, h, w)
    mean = _group_mean(xg)
    centered = xg - mean
    var = _group_mean(centered * centered)
    xg = centered / torch.sqrt(var + eps)
    return (xg.reshape(b, c, h, w) * scale.reshape(1, c, 1, 1)
            + bias.reshape(1, c, 1, 1))


def _group_mean(xg):
    """Mean over a group's channels and positions, rounded as XLA rounds
    ``jnp.mean``: the sum times the float32 reciprocal of the count."""
    n = xg.shape[2] * xg.shape[3] * xg.shape[4]
    return xg.sum(dim=(2, 3, 4), keepdim=True) * torch.reciprocal(
        torch.full((), float(n), dtype=xg.dtype, device=xg.device))


def _mask_channels(h, masks, name):
    """Zero the feature maps of pruned filters (``masks[name]``: [d] of
    0/1 on the channel axis 1).  For 0/1 masks this equals masking the
    layer's weight and bias, since relu(z) * m == relu(z * m)."""
    if masks is None or name not in masks:
        return h
    return h * masks[name].reshape(1, -1, *([1] * (h.ndim - 2)))


def softmax_xent_acc(logits, y):
    """(mean cross-entropy, accuracy) of ``logits`` [B, classes] against
    integer labels ``y`` [B]."""
    y = y.long()
    logp = F.log_softmax(logits, dim=-1)
    loss = -logp.gather(1, y[:, None]).mean()
    acc = (logits.argmax(-1) == y).float().mean()
    return loss, acc


def _nchw(x):
    """NHWC images -> contiguous NCHW.  Not the channels_last view that
    ``permute`` alone gives: on a channels_last input, PyTorch 2.13's CPU
    convolution returns a wrong weight gradient for a 1x1 stride-2 conv
    (ResNet18's ``proj`` at 16x16: off by 8-20 against float64) and
    corrupts the heap."""
    return x.permute(0, 3, 1, 2).contiguous()


def _dense_in(h):
    """The last feature map [B, C, H, W] as fc1's [B, H*W*C] input, in
    NHWC order (spatial index h * W + w, then channel)."""
    return h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)


def _dense(h, p, masks, name):
    """relu(h @ w + b), through ``masked_dense`` when ``name`` is masked;
    ``w`` may be fc1's [spatial, C, out]."""
    w = p["w"].reshape(-1, p["w"].shape[-1])
    if masks is not None and name in masks:
        return F.relu(masked_dense(h, w, masks[name], b=p["b"]))
    return F.relu(h @ w + p["b"])


def _conv_flops(w, h, wd) -> float:
    cout, cin, kh, kw = w.shape
    return 2 * kh * kw * cin * cout * h * wd


# ---------------------------------------------------------------------------
# model base
# ---------------------------------------------------------------------------

class _Init:
    """He-normal initialisers drawing from one ``torch.Generator``."""

    def __init__(self, generator: torch.Generator, device):
        self.gen, self.dev = generator, device

    def he(self, shape, fan_in):
        return (torch.randn(shape, generator=self.gen, dtype=torch.float32,
                            device=self.dev) * math.sqrt(2.0 / fan_in))

    def zeros(self, n):
        return torch.zeros((n,), dtype=torch.float32, device=self.dev)

    def ones(self, n):
        return torch.ones((n,), dtype=torch.float32, device=self.dev)

    def conv(self, kh, kw, cin, cout):
        return {"w": self.he((cout, cin, kh, kw), kh * kw * cin),
                "b": self.zeros(cout)}

    def dense(self, fin, fout):
        return {"w": self.he((fin, fout), fin), "b": self.zeros(fout)}


@dataclasses.dataclass
class PaperModel:
    """Functional-model facade shared by the paper models."""

    device: Any = dataclasses.field(default="cuda", kw_only=True)

    def __post_init__(self):
        self.device = _device.resolve(self.device)

    def init(self, generator: torch.Generator) -> dict:
        raise NotImplementedError

    def apply(self, params, x, *, collect: bool = False, masks=None):
        raise NotImplementedError

    def loss_and_acc(self, params, x, y, *, masks=None):
        return softmax_xent_acc(self.apply(params, x, masks=masks), y)

    def feature_maps(self, params, x) -> dict:
        """{layer name: NCHW (or [B, d]) post-activation feature maps}."""
        return self.apply(params, x, collect=True)[1]

    def prune_spec(self, params) -> PruneSpec:
        raise NotImplementedError

    def with_pruned(self, kept) -> "PaperModel":
        return self  # apply() reads every width from the params

    def flops_per_example(self, params, image_shape=None) -> float:
        """Analytic MAC-based FLOPs (the paper's MFLOPs columns)."""
        raise NotImplementedError


def _conv_layer(name, nxt: CoupledParam) -> PrunableLayer:
    """A conv's filters (OIHW axis 0) with its bias and the next layer's
    input slice."""
    return PrunableLayer(name, (name, "w"), 0,
                         (CoupledParam((name, "b"), 0), nxt))


# ---------------------------------------------------------------------------
# SimpleCNN — the paper's synthetic 122,570-param network
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SimpleCNN(PaperModel):
    num_classes: int = 10
    image_shape: tuple = (32, 32, 3)
    channels: tuple = (32, 64, 64)
    fc_width: int = 64

    def init(self, generator):
        ini = _Init(generator, self.device)
        h, w, c = self.image_shape
        h2, w2 = (h + 3) // 4, (w + 3) // 4       # two SAME pools
        spatial = h2 * w2
        return {
            "conv1": ini.conv(3, 3, c, self.channels[0]),
            "conv2": ini.conv(3, 3, self.channels[0], self.channels[1]),
            "conv3": ini.conv(3, 3, self.channels[1], self.channels[2]),
            "fc1": {"w": ini.he((spatial, self.channels[2], self.fc_width),
                                spatial * self.channels[2]),
                    "b": ini.zeros(self.fc_width)},
            "out": ini.dense(self.fc_width, self.num_classes),
        }

    def apply(self, params, x, *, collect=False, masks=None):
        fmaps = {}
        h = _nchw(x)
        for i, name in enumerate(("conv1", "conv2", "conv3")):
            if i:
                h = max_pool(h)
            h = F.relu(conv2d(h, params[name]["w"], params[name]["b"]))
            h = _mask_channels(h, masks, name)
            fmaps[name] = h
        h = _dense(_dense_in(h), params["fc1"], masks, "fc1")
        fmaps["fc1"] = h
        logits = h @ params["out"]["w"] + params["out"]["b"]
        return (logits, fmaps) if collect else logits

    def prune_spec(self, params):
        return PruneSpec(layers=(
            _conv_layer("conv1", CoupledParam(("conv2", "w"), 1)),
            _conv_layer("conv2", CoupledParam(("conv3", "w"), 1)),
            _conv_layer("conv3", CoupledParam(("fc1", "w"), 1)),
        ))

    def flops_per_example(self, params, image_shape=None):
        h, w, _ = image_shape or self.image_shape
        shapes = [(h, w), ((h + 1) // 2, (w + 1) // 2),
                  ((h + 3) // 4, (w + 3) // 4)]
        f = sum(_conv_flops(params[n]["w"], *s)
                for n, s in zip(("conv1", "conv2", "conv3"), shapes))
        return float(f + 2 * params["fc1"]["w"].numel()
                     + 2 * params["out"]["w"].numel())


# ---------------------------------------------------------------------------
# LeNet5
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class LeNet5(PaperModel):
    num_classes: int = 10
    image_shape: tuple = (32, 32, 3)

    def init(self, generator):
        ini = _Init(generator, self.device)
        h, w, c = self.image_shape
        spatial = ((h + 3) // 4) * ((w + 3) // 4)
        return {
            "conv1": ini.conv(5, 5, c, 6),
            "conv2": ini.conv(5, 5, 6, 16),
            "fc1": {"w": ini.he((spatial, 16, 120), spatial * 16),
                    "b": ini.zeros(120)},
            "fc2": ini.dense(120, 84),
            "out": ini.dense(84, self.num_classes),
        }

    def apply(self, params, x, *, collect=False, masks=None):
        fmaps = {}
        h = _nchw(x)
        for name in ("conv1", "conv2"):
            h = F.relu(conv2d(h, params[name]["w"], params[name]["b"]))
            h = _mask_channels(h, masks, name)
            fmaps[name] = h
            h = max_pool(h)
        h = _dense(_dense_in(h), params["fc1"], masks, "fc1")
        fmaps["fc1"] = h
        h = _dense(h, params["fc2"], masks, "fc2")
        fmaps["fc2"] = h
        logits = h @ params["out"]["w"] + params["out"]["b"]
        return (logits, fmaps) if collect else logits

    def prune_spec(self, params):
        return PruneSpec(layers=(
            _conv_layer("conv1", CoupledParam(("conv2", "w"), 1)),
            _conv_layer("conv2", CoupledParam(("fc1", "w"), 1)),
            PrunableLayer("fc1", ("fc1", "w"), 2,
                          (CoupledParam(("fc1", "b"), 0),
                           CoupledParam(("fc2", "w"), 0))),
            PrunableLayer("fc2", ("fc2", "w"), 1,
                          (CoupledParam(("fc2", "b"), 0),
                           CoupledParam(("out", "w"), 0))),
        ))

    def flops_per_example(self, params, image_shape=None):
        h, w, _ = image_shape or self.image_shape
        f = (_conv_flops(params["conv1"]["w"], h, w)
             + _conv_flops(params["conv2"]["w"], (h + 1) // 2, (w + 1) // 2))
        return float(f + sum(2 * params[n]["w"].numel()
                             for n in ("fc1", "fc2", "out")))


# ---------------------------------------------------------------------------
# VGG11 (CIFAR variant)
# ---------------------------------------------------------------------------

_VGG11_PLAN = [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"]


@dataclasses.dataclass
class VGG11(PaperModel):
    num_classes: int = 10
    image_shape: tuple = (32, 32, 3)
    width_mult: float = 1.0

    def _plan(self):
        return [v if v == "M" else max(8, int(v * self.width_mult))
                for v in _VGG11_PLAN]

    def init(self, generator):
        ini = _Init(generator, self.device)
        params, cin = {}, self.image_shape[-1]
        for i, v in enumerate(v for v in self._plan() if v != "M"):
            params[f"conv{i}"] = ini.conv(3, 3, cin, v)
            cin = v
        params["out"] = ini.dense(cin, self.num_classes)
        return params

    def apply(self, params, x, *, collect=False, masks=None):
        fmaps = {}
        h = _nchw(x)
        ci = 0
        for v in self._plan():
            if v == "M":
                h = max_pool(h)
                continue
            name = f"conv{ci}"
            h = F.relu(conv2d(h, params[name]["w"], params[name]["b"]))
            h = _mask_channels(h, masks, name)
            fmaps[name] = h
            ci += 1
        h = avg_pool_global(h)
        logits = h @ params["out"]["w"] + params["out"]["b"]
        return (logits, fmaps) if collect else logits

    def prune_spec(self, params):
        n = sum(1 for v in _VGG11_PLAN if v != "M")
        return PruneSpec(layers=tuple(
            _conv_layer(f"conv{i}",
                        CoupledParam((f"conv{i + 1}", "w"), 1) if i + 1 < n
                        else CoupledParam(("out", "w"), 0))
            for i in range(n)))

    def flops_per_example(self, params, image_shape=None):
        h, w, _ = image_shape or self.image_shape
        f, ci = 0.0, 0
        for v in self._plan():
            if v == "M":
                h, w = (h + 1) // 2, (w + 1) // 2
            else:
                f += _conv_flops(params[f"conv{ci}"]["w"], h, w)
                ci += 1
        return float(f + 2 * params["out"]["w"].numel())


# ---------------------------------------------------------------------------
# ResNet18 with GroupNorm
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ResNet18(PaperModel):
    num_classes: int = 100
    image_shape: tuple = (32, 32, 3)
    width: int = 64

    _stages = (2, 2, 2, 2)

    def _blocks(self):
        """(name, stride) of every basic block, in order."""
        return [(f"s{s}b{b}", 2 if (b == 0 and s > 0) else 1)
                for s, n in enumerate(self._stages) for b in range(n)]

    def init(self, generator):
        ini = _Init(generator, self.device)
        w0 = self.width
        params = {"stem": ini.conv(3, 3, self.image_shape[-1], w0),
                  "stem_gn": {"scale": ini.ones(w0), "bias": ini.zeros(w0)}}
        cin = w0
        for name, stride in self._blocks():
            cout = w0 * 2 ** int(name[1])
            blk = {
                "conv1": ini.conv(3, 3, cin, cout),
                "gn1": {"scale": ini.ones(cout), "bias": ini.zeros(cout)},
                "conv2": ini.conv(3, 3, cout, cout),
                "gn2": {"scale": ini.ones(cout), "bias": ini.zeros(cout)},
            }
            if stride != 1 or cin != cout:
                blk["proj"] = ini.conv(1, 1, cin, cout)
            params[name] = blk
            cin = cout
        params["out"] = ini.dense(cin, self.num_classes)
        return params

    def apply(self, params, x, *, collect=False, masks=None):
        fmaps = {}
        h = F.relu(group_norm(
            conv2d(_nchw(x), params["stem"]["w"], params["stem"]["b"]),
            params["stem_gn"]["scale"], params["stem_gn"]["bias"]))
        for name, stride in self._blocks():
            blk = params[name]
            y = F.relu(group_norm(
                conv2d(h, blk["conv1"]["w"], blk["conv1"]["b"],
                       stride=stride),
                blk["gn1"]["scale"], blk["gn1"]["bias"]))
            y = _mask_channels(y, masks, f"{name}.conv1")
            fmaps[f"{name}.conv1"] = y
            y = group_norm(conv2d(y, blk["conv2"]["w"], blk["conv2"]["b"]),
                           blk["gn2"]["scale"], blk["gn2"]["bias"])
            sc = h
            if "proj" in blk:
                sc = conv2d(h, blk["proj"]["w"], blk["proj"]["b"],
                            stride=stride)
            h = F.relu(y + sc)
        h = avg_pool_global(h)
        logits = h @ params["out"]["w"] + params["out"]["b"]
        return (logits, fmaps) if collect else logits

    def prune_spec(self, params):
        # only each block's first conv: its output feeds conv2 alone, so
        # the residual shapes stay
        return PruneSpec(layers=tuple(
            PrunableLayer(f"{name}.conv1", (name, "conv1", "w"), 0,
                          (CoupledParam((name, "conv1", "b"), 0),
                           CoupledParam((name, "gn1", "scale"), 0),
                           CoupledParam((name, "gn1", "bias"), 0),
                           CoupledParam((name, "conv2", "w"), 1)))
            for name, _ in self._blocks()))

    def flops_per_example(self, params, image_shape=None):
        h, w, _ = image_shape or self.image_shape
        f = 2 * 9 * self.image_shape[-1] * params["stem"]["w"].shape[0] * h * w
        for name, stride in self._blocks():
            blk = params[name]
            h, w = (h + stride - 1) // stride, (w + stride - 1) // stride
            for cname in ("conv1", "conv2", "proj"):
                if cname in blk:
                    f += _conv_flops(blk[cname]["w"], h, w)
        return float(f + 2 * params["out"]["w"].numel())
