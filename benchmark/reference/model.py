"""Plain PyTorch reference of the incremental segmentation model: a dilated
ResNet body, the DeepLab-v3 ASPP head and one 1x1 classifier per step,
written as functions over a flat state dict (name -> tensor).

It follows the model the benchmark measures as its tests state it: ABN
blocks (BatchNorm, then leaky ReLU 0.01; identity on the last norm of each
residual block and of the projection shortcuts), a leaky ReLU after each
residual add, train-mode BatchNorm normalizing with the batch's biased
variance and the running statistics moving by momentum 0.1 towards the
batch mean and biased variance, the ASPP pooling branch a global mean in
train mode and a sliding mean of `pooling` (replicate-padded back) in eval
mode, the classifiers on the head's output, and the detached spatial
attention maps of the UCD term. uint8 RGB input is normalized with the
ImageNet mean and std.

Nothing here imports the measured program. The key names of the state dict
are the ones both sides are handed, so one dict of seeded tensors feeds
both. Every tensor is computed in the dtype of the state dict (float32 on
the card, float64 in the CPU tests); `q`, where given, rounds the inputs,
weights and outputs of every convolution and the output of every ABN and
residual block: the control computed at a lower precision.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterator, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

STRUCTURES = {"resnet50": (3, 4, 6, 3), "resnet101": (3, 4, 23, 3)}
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
SLOPE = 0.01
EPS = 1e-5
MOMENTUM = 0.1

Tensor = torch.Tensor
Round = Optional[Callable[[Tensor], Tensor]]


def _same(x: Tensor) -> Tensor:
    return x


def conv_specs(arch: dict) -> Iterator[Tuple[str, int, int, int, int, int,
                                             str]]:
    """Every convolution of the model in forward order: (name, in, out,
    kernel, stride, dilation, where), `where` one of "stem", "body",
    "head", "pool" (the pooling branch, on a 1x1 map in train mode) and
    "cls"."""
    dil = {16: (1, 1, 1, 2), 8: (1, 1, 2, 4)}[arch["output_stride"]]
    yield "body.mod1_conv1", 3, 64, 7, 2, 1, "stem"
    ch, cin = (64, 64, 256), 64
    for g, n in enumerate(STRUCTURES[arch["backbone"]]):
        for b in range(n):
            p = f"body.mod{g + 2}_block{b + 1}"
            stride = 2 if dil[g] == 1 and b == 0 and g > 0 else 1
            if stride != 1 or cin != ch[2]:
                yield f"{p}.proj_conv", cin, ch[2], 1, stride, 1, "body"
            yield f"{p}.conv1", cin, ch[0], 1, 1, 1, "body"
            yield f"{p}.conv2", ch[0], ch[1], 3, stride, dil[g], "body"
            yield f"{p}.conv3", ch[1], ch[2], 1, 1, 1, "body"
            cin = ch[2]
        ch = tuple(2 * c for c in ch)
    hc = arch["head_channels"]
    rates = (6, 12, 18) if arch["output_stride"] == 16 else (12, 24, 32)
    yield "head.map_conv0", cin, 256, 1, 1, 1, "head"
    for i, r in enumerate(rates):
        yield f"head.map_conv{i + 1}", cin, 256, 3, 1, r, "head"
    yield "head.red_conv", 4 * 256, hc, 1, 1, 1, "head"
    yield "head.global_pooling_conv", cin, 256, 1, 1, 1, "pool"
    yield "head.pool_red_conv", 256, hc, 1, 1, 1, "pool"
    for i, c in enumerate(arch["classes"]):
        yield f"cls_{i}", hc, c, 1, 1, 1, "cls"


def norm_names(arch: dict) -> Iterator[Tuple[str, int]]:
    """(prefix, channels) of every BatchNorm."""
    for name, _, cout, _, _, _, where in conv_specs(arch):
        if where == "cls" or name == "head.global_pooling_conv":
            continue
        if name.startswith("head.map_conv") or name == "head.red_conv":
            continue
        if name == "head.pool_red_conv":
            yield "head.global_pooling_bn.bn", 256
            continue
        if name == "body.mod1_conv1":
            yield "body.mod1_bn1.bn", cout
            continue
        yield name.replace("_conv", "_bn").replace("conv", "bn") + ".bn", cout
    yield "head.map_bn.bn", 4 * 256
    yield "head.red_bn.bn", arch["head_channels"]


BRANCH_SCALE = 0.1


def init_state(arch: dict, generator: torch.Generator, device,
               dtype=torch.float32) -> Dict[str, Tensor]:
    """Seeded weights on `device` in a few large draws: each conv a normal
    of std sqrt(2 / fan_in) (the classifiers' sqrt(1 / fan_in), biases 0),
    BatchNorm scale 1 + 0.1 N(0, 1) and bias 0.1 N(0, 1), running mean 0
    and variance 1 until `calibrate` sets them. The last BatchNorm of each
    residual branch (`bn3`) has its scale times BRANCH_SCALE: a deep
    residual net whose branches all start at full scale is chaotic (a
    rounding of its input moves its logits by whole units, which a trained
    net's do not), and a precision check on it would compare noise."""
    specs = list(conv_specs(arch))
    sizes = [o * i * k * k for _, i, o, k, _, _, _ in specs]
    flat = torch.randn(sum(sizes), generator=generator, device=device,
                       dtype=dtype)
    sd, at = {}, 0
    for (name, i, o, k, _, _, where), n in zip(specs, sizes):
        std = math.sqrt((1.0 if where == "cls" else 2.0) / (i * k * k))
        w = flat[at:at + n].view(o, i, k, k).mul_(std)
        at += n
        if where == "cls":
            sd[f"{name}.weight"] = w
            sd[f"{name}.bias"] = torch.zeros(o, device=device, dtype=dtype)
        else:
            sd[f"{name}.weight"] = w
    norms = list(norm_names(arch))
    total = sum(c for _, c in norms)
    aff = torch.randn(2, total, generator=generator, device=device,
                      dtype=dtype).mul_(0.1)
    at = 0
    for p, c in norms:
        sd[f"{p}.weight"] = (aff[0, at:at + c] + 1.0) * (
            BRANCH_SCALE if p.endswith(".bn3.bn") else 1.0)
        sd[f"{p}.bias"] = aff[1, at:at + c].clone()
        sd[f"{p}.running_mean"] = torch.zeros(c, device=device, dtype=dtype)
        sd[f"{p}.running_var"] = torch.ones(c, device=device, dtype=dtype)
        sd[f"{p}.num_batches_tracked"] = torch.zeros(
            (), device=device, dtype=torch.int64)
        at += c
    return sd


def normalize(x: Tensor, dtype) -> Tensor:
    """uint8 NCHW RGB -> ImageNet-normalized `dtype`, with the mean and
    std held as float32 numbers, as the data pipeline states them."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32,
                        device=x.device).to(dtype)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32,
                       device=x.device).to(dtype)
    return (x.to(dtype) / 255.0 - mean.view(1, 3, 1, 1)) / std.view(1, 3, 1, 1)


class _Net:
    """One forward pass over `sd`. `train`: batch statistics, recorded in
    `self.stats` (prefix -> (mean, biased variance)) for the running
    update."""

    def __init__(self, sd, arch, train: bool, q: Round):
        self.sd, self.arch, self.train = sd, arch, train
        self.q = q or _same
        self.stats: Dict[str, Tuple[Tensor, Tensor]] = {}

    def conv(self, name, x, stride=1, dilation=1):
        w = self.sd[f"{name}.weight"]
        pad = dilation * (w.shape[-1] - 1) // 2
        return self.q(F.conv2d(self.q(x), self.q(w), None, stride, pad,
                               dilation))

    def bn(self, prefix, x, act=True):
        w, b = self.sd[f"{prefix}.weight"], self.sd[f"{prefix}.bias"]
        if self.train:
            y = F.batch_norm(x, None, None, w, b, True, 0.0, EPS)
            with torch.no_grad():
                var, mean = torch.var_mean(x.detach(), dim=(0, 2, 3),
                                           correction=0)
            self.stats[prefix] = (mean, var)
        else:
            y = F.batch_norm(x, self.sd[f"{prefix}.running_mean"],
                             self.sd[f"{prefix}.running_var"], w, b, False,
                             0.0, EPS)
        return self.q(F.leaky_relu(y, SLOPE) if act else y)

    def block(self, p, x, stride, dilation, project):
        res = self.bn(f"{p}.proj_bn.bn", self.conv(f"{p}.proj_conv", x,
                                                   stride), act=False) \
            if project else x
        y = self.bn(f"{p}.bn1.bn", self.conv(f"{p}.conv1", x))
        y = self.bn(f"{p}.bn2.bn", self.conv(f"{p}.conv2", y, stride,
                                             dilation))
        y = self.bn(f"{p}.bn3.bn", self.conv(f"{p}.conv3", y), act=False)
        return self.q(F.leaky_relu(y + res, SLOPE))

    def body(self, x):
        arch = self.arch
        dil = {16: (1, 1, 1, 2), 8: (1, 1, 2, 4)}[arch["output_stride"]]
        y = self.bn("body.mod1_bn1.bn", self.conv("body.mod1_conv1", x, 2))
        y = F.max_pool2d(y, 3, stride=2, padding=1)
        cin, cout = 64, 256
        for g, n in enumerate(STRUCTURES[arch["backbone"]]):
            for b in range(n):
                stride = 2 if dil[g] == 1 and b == 0 and g > 0 else 1
                y = self.block(f"body.mod{g + 2}_block{b + 1}", y, stride,
                               dil[g], stride != 1 or cin != cout)
                cin = cout
            cout *= 2
        return y

    def pool(self, x):
        if self.train:
            return x.mean(dim=(2, 3), keepdim=True)
        h, w = x.shape[2], x.shape[3]
        ph, pw = min(self.arch["pooling"], h), min(self.arch["pooling"], w)
        y = F.avg_pool2d(x, (ph, pw), stride=1)
        left, top = (pw - 1) // 2, (ph - 1) // 2
        return F.pad(y, (left, pw - 1 - left, top, ph - 1 - top),
                     mode="replicate")

    def head(self, x):
        rates = (6, 12, 18) if self.arch["output_stride"] == 16 \
            else (12, 24, 32)
        out = torch.cat([self.conv("head.map_conv0", x)]
                        + [self.conv(f"head.map_conv{i + 1}", x, 1, r)
                           for i, r in enumerate(rates)], dim=1)
        out = self.conv("head.red_conv", self.bn("head.map_bn.bn", out))
        pool = self.bn("head.global_pooling_bn.bn",
                       self.conv("head.global_pooling_conv", self.pool(x)))
        pool = self.conv("head.pool_red_conv", pool)
        return self.bn("head.red_bn.bn", out + pool)

    def classify(self, x_pl):
        return torch.cat([F.conv2d(x_pl, self.sd[f"cls_{i}.weight"],
                                   self.sd[f"cls_{i}.bias"])
                          for i in range(len(self.arch["classes"]))], dim=1)


def att_map(x: Tensor) -> Tensor:
    """x * a with a = sum_c x^2 / ||sum_c x^2|| over the map, detached."""
    a = (x ** 2).sum(dim=1, keepdim=True)
    norm = (a ** 2).sum(dim=(2, 3), keepdim=True).sqrt()
    return (a / norm.clamp_min(1e-12)).detach() * x


def forward(sd: Dict[str, Tensor], x: Tensor, arch: dict, train: bool,
            attention: bool = False, q: Round = None):
    """(sem low-res logits NCHW, {"pre_logits": attended head output} when
    `attention`, batch statistics of a train-mode pass). `x` is uint8 NCHW
    RGB or already normalized."""
    dtype = sd["cls_0.weight"].dtype
    if x.dtype == torch.uint8:
        x = normalize(x, dtype)
    net = _Net(sd, arch, train, q)
    x_pl = net.head(net.body(x))
    sem = net.classify(x_pl)
    feats = {"pre_logits": att_map(x_pl)} if attention else {}
    return sem, feats, net.stats


@torch.no_grad()
def calibrate(sd: Dict[str, Tensor], arch: dict, images: Tensor) -> None:
    """In place: every BatchNorm's running statistics set to the mean and
    biased variance of its input over the uint8 NHWC batch `images` (each
    norm seeing the previous ones' outputs as a train-mode pass gives
    them), then each classifier output centered and scaled over the same
    batch to mean 0 and standard deviation 2, so that a seeded model
    predicts several classes across each image as a trained one does."""
    x = images.permute(0, 3, 1, 2)
    _, _, stats = forward(sd, x, arch, train=True)
    for prefix, (mean, var) in stats.items():
        sd[f"{prefix}.running_mean"].copy_(mean)
        sd[f"{prefix}.running_var"].copy_(var)
    sem, _, _ = forward(sd, x, arch, train=False)
    mu = sem.mean(dim=(0, 2, 3))
    scale = 2.0 / sem.std(dim=(0, 2, 3)).clamp_min(1e-6)
    k = 0
    for i, c in enumerate(arch["classes"]):
        s = scale[k:k + c]
        sd[f"cls_{i}.weight"].mul_(s.view(-1, 1, 1, 1))
        sd[f"cls_{i}.bias"].sub_(mu[k:k + c]).mul_(s)
        k += c


def grow(donor: Dict[str, Tensor], arch: dict,
         new_classes: int) -> Dict[str, Tensor]:
    """The next step's model from the donor's state: every donor tensor
    copied, and the new classifier MiB-imprinted from the background row of
    cls_0 (weight copied, bias = background bias - log(new + 1), also
    written to cls_0's background bias)."""
    sd = {k: v.clone() for k, v in donor.items()}
    last = len(arch["classes"]) - 1
    w0, b0 = sd["cls_0.weight"], sd["cls_0.bias"]
    bias = b0[0] - math.log(new_classes + 1)
    sd[f"cls_{last}.weight"] = w0[0:1].expand(
        arch["classes"][last], -1, -1, -1).clone()
    sd[f"cls_{last}.bias"] = bias.expand(arch["classes"][last]).clone()
    b0[0] = bias
    return sd


def trainable(name: str, step: int) -> bool:
    """Parameters the step trains: all but cls_0 after step 0, and never a
    BatchNorm statistic."""
    if name.endswith(("running_mean", "running_var", "num_batches_tracked")):
        return False
    return not (step > 0 and name.startswith("cls_0."))


def upsample(x: Tensor, hw: Sequence[int]) -> Tensor:
    return F.interpolate(x, size=tuple(hw), mode="bilinear",
                         align_corners=False)
