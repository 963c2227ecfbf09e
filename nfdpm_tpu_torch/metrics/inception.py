"""Inception-v3 feature extractor of FID (clean-fid compatible), NCHW inside.

Counterpart of nfdpm_tpu/metrics/inception.py: the network clean-fid
evaluates (the TF "pt_inception-2015-12-05" port), torchvision's
InceptionV3 with the FID-specific layers: InceptionA, C and the first E
average-pool with count_include_pad=False, the last InceptionE max-pools its
pool branch, batch norm with eps 1e-3 and inference constants, a global mean
pool to the 2048-d "pool3" features.

Module names are torchvision's, so `pt_inception-2015-12-05-6726825d.pth`
loads straight in (`load_weights`: strict, without the classifier heads
`fc.*` and `AuxLogits.*` that the features never use). Without that file,
`random_init` gives a seeded random network: the FID/KID pipeline is the
same, and the values are comparable with clean-fid's only under the real
weights.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from .. import disable_tf32

WEIGHTS_FILE = "pt_inception-2015-12-05-6726825d.pth"
FEATURE_DIM = 2048
UNUSED_PREFIXES = ("fc.", "AuxLogits.")


class BasicConv2d(nn.Module):
    """Bias-free convolution, batch norm (eps 1e-3, running statistics), ReLU."""

    def __init__(self, cin: int, cout: int, **kw):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, bias=False, **kw)
        self.bn = nn.BatchNorm2d(cout, eps=1e-3)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


def _avg3(x):
    """3x3 stride-1 average pool that counts only the pixels inside (FID's variant)."""
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 64, kernel_size=1)
        self.branch5x5_1 = BasicConv2d(cin, 48, kernel_size=1)
        self.branch5x5_2 = BasicConv2d(48, 64, kernel_size=5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, kernel_size=1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, kernel_size=3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, kernel_size=3, padding=1)
        self.branch_pool = BasicConv2d(cin, pool_features, kernel_size=1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(_avg3(x))
        return torch.cat([b1, b5, bd, bp], 1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(cin, 384, kernel_size=3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, kernel_size=1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, kernel_size=3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, kernel_size=3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3(x)
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([b3, bd, F.max_pool2d(x, 3, stride=2)], 1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, c7: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 192, kernel_size=1)
        self.branch7x7_1 = BasicConv2d(cin, c7, kernel_size=1)
        self.branch7x7_2 = BasicConv2d(c7, c7, kernel_size=(1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, kernel_size=(7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(cin, c7, kernel_size=1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, kernel_size=(7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, kernel_size=(1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, kernel_size=(7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, kernel_size=(1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(cin, 192, kernel_size=1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_5(self.branch7x7dbl_4(
            self.branch7x7dbl_3(self.branch7x7dbl_2(self.branch7x7dbl_1(x)))))
        bp = self.branch_pool(_avg3(x))
        return torch.cat([b1, b7, bd, bp], 1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(cin, 192, kernel_size=1)
        self.branch3x3_2 = BasicConv2d(192, 320, kernel_size=3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(cin, 192, kernel_size=1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, kernel_size=(1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, kernel_size=(7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, kernel_size=3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = self.branch7x7x3_4(self.branch7x7x3_3(self.branch7x7x3_2(self.branch7x7x3_1(x))))
        return torch.cat([b3, b7, F.max_pool2d(x, 3, stride=2)], 1)


class InceptionE(nn.Module):
    def __init__(self, cin: int, pool_mode: str):
        super().__init__()
        self.pool_mode = pool_mode  # "avg" (Mixed_7b) or "max" (Mixed_7c)
        self.branch1x1 = BasicConv2d(cin, 320, kernel_size=1)
        self.branch3x3_1 = BasicConv2d(cin, 384, kernel_size=1)
        self.branch3x3_2a = BasicConv2d(384, 384, kernel_size=(1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, kernel_size=(3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(cin, 448, kernel_size=1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, kernel_size=3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, kernel_size=(1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, kernel_size=(3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(cin, 192, kernel_size=1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], 1)
        bp = _avg3(x) if self.pool_mode == "avg" else F.max_pool2d(x, 3, stride=1, padding=1)
        return torch.cat([b1, b3, bd, self.branch_pool(bp)], 1)


class FIDInceptionV3(nn.Module):
    """x [B, 3, 299, 299] scaled to [-1, 1] -> [B, 2048] pool3 features."""

    def __init__(self):
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, kernel_size=3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, kernel_size=3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, kernel_size=3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, kernel_size=1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, kernel_size=3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280, "avg")
        self.Mixed_7c = InceptionE(2048, "max")

    def forward(self, x):
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = F.max_pool2d(x, 3, stride=2)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = F.max_pool2d(x, 3, stride=2)
        for block in (self.Mixed_5b, self.Mixed_5c, self.Mixed_5d, self.Mixed_6a,
                      self.Mixed_6b, self.Mixed_6c, self.Mixed_6d, self.Mixed_6e,
                      self.Mixed_7a, self.Mixed_7b, self.Mixed_7c):
            x = block(x)
        return x.mean(dim=(2, 3))


def random_init(seed: int = 0) -> FIDInceptionV3:
    """A seeded random network in eval mode: convolutions N(0, 2 / fan_in)
    (He's scale, so that the features keep their size through the 94
    ReLU layers), batch norm at its identity (mean 0, var 1, gamma 1, beta 0)."""
    model = FIDInceptionV3().eval()
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv2d):
                fan_in = m.weight[0].numel()
                m.weight.normal_(0.0, math.sqrt(2.0 / fan_in), generator=gen)
    return model


def load_weights(path: str) -> FIDInceptionV3:
    """The network with the pt_inception .pth file's weights (strict, but
    for the classifier heads and the batch-norm step counters)."""
    sd = torch.load(path, map_location="cpu")
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    model = FIDInceptionV3().eval()
    expected = model.state_dict()
    sd = {k: v for k, v in sd.items() if not k.startswith(UNUSED_PREFIXES)}
    for k in expected:
        if k.endswith("num_batches_tracked"):
            sd.setdefault(k, expected[k])
    model.load_state_dict(sd, strict=True)
    return model


def make_feature_fn(model: FIDInceptionV3, device=None):
    """fn(x): float [B, 299, 299, 3] in [0, 255] (NHWC) -> [B, 2048] on
    `device`, after the TF port's scaling (x - 128) / 128."""
    disable_tf32()
    model = model.to(device).eval()

    @torch.inference_mode()
    def features(x: torch.Tensor) -> torch.Tensor:
        x = (x.to(device).float() - 128.0) / 128.0
        return model(x.permute(0, 3, 1, 2))

    features.model = model
    return features
