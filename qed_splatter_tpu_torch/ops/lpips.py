"""LPIPS perceptual metric, AlexNet and VGG16 backbones (port of
``ops/lpips.py``).

The computation of torchmetrics' ``LearnedPerceptualImagePatchSimilarity``,
which the reference builds with its defaults: ``net_type="alex"`` and
``normalize=False``, fed [0, 1] images, so the scaling layer sees [0, 1]
directly; ``normalize=True`` rescales to [-1, 1] first (richzhang's
convention). Convolutions and pools are ``F.conv2d`` / ``F.max_pool2d`` on
the images' device; a caller that wants float32 on the GPU turns TF32 off
(``torch.backends.cudnn.allow_tf32``).

Backbone taps (torchvision ``features`` indices of the convolutions):

- alex: relu1..relu5 (convolutions at 0, 3, 6, 8, 10; 3x3 / 2 max pools
  after relu1 and relu2)
- vgg16: relu1_2 / 2_2 / 3_3 / 4_3 / 5_3 (2x2 / 2 max pools between blocks)

Pretrained weights are not shipped and never downloaded: they come as an
``.npz`` (``LPIPS.from_npz``) with ``features.{i}.weight`` / ``.bias`` for the
backbone (any prefix) and ``lin{k}...weight`` for the five 1x1 heads, i.e.
``np.savez(path, **state_dict)`` of the torchmetrics checkpoint. The backbone
is detected from which convolution indices exist.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

# (conv feature index, stride, padding) per backbone, the convolutions
# followed by a tap, and those followed by a max pool (after the tap)
_ARCH: Dict[str, dict] = {
    "vgg": dict(
        convs=[(i, 1, 1) for i in
               (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)],
        taps={2, 7, 14, 21, 28},
        pools={2: (2, 2), 7: (2, 2), 14: (2, 2), 21: (2, 2)},
    ),
    "alex": dict(
        convs=[(0, 4, 2), (3, 1, 2), (6, 1, 1), (8, 1, 1), (10, 1, 1)],
        taps={0, 3, 6, 8, 10},
        pools={0: (3, 2), 3: (3, 2)},
    ),
}

_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


class LPIPS:
    """Functional LPIPS; ``normalize=False`` with [0, 1] inputs is the
    reference's torchmetrics default. Weights live on the host and are
    copied to each image device once."""

    def __init__(self, convs: Sequence[np.ndarray],
                 biases: Sequence[np.ndarray],
                 heads: Sequence[np.ndarray], net_type: str = "alex",
                 normalize: bool = False):
        if net_type not in _ARCH:
            raise ValueError(f"net_type must be one of {list(_ARCH)}")
        self.net_type = net_type
        self.normalize = normalize
        self._host = ([torch.as_tensor(np.asarray(w, np.float32))
                       for w in convs],                       # [O, I, kh, kw]
                      [torch.as_tensor(np.asarray(b, np.float32))
                       for b in biases],                      # [O]
                      [torch.as_tensor(np.asarray(h, np.float32)).reshape(
                          1, -1, 1, 1) for h in heads])        # [1, C, 1, 1]
        self._on: Dict[torch.device, tuple] = {}

    @classmethod
    def from_npz(cls, path: str, normalize: bool = False) -> "LPIPS":
        data = dict(np.load(path))

        def find(key: str) -> str:
            cands = [k for k in data if k.endswith(key)]
            if not cands:
                raise KeyError(f"LPIPS npz missing {key}")
            return cands[0]

        # vgg16 has a convolution at features index 28
        net_type = "vgg" if any(
            k.endswith("features.28.weight") for k in data) else "alex"
        convs, biases = [], []
        for i, _, _ in _ARCH[net_type]["convs"]:
            k = find(f"features.{i}.weight")
            convs.append(data[k])
            biases.append(data[k.replace("weight", "bias")])
        heads = []
        for k in range(5):
            cands = [key for key in data
                     if f"lin{k}" in key and key.endswith("weight")]
            if not cands:
                raise KeyError(f"LPIPS npz missing lin{k} head")
            heads.append(data[cands[0]])
        return cls(convs, biases, heads, net_type=net_type,
                   normalize=normalize)

    def _weights(self, dev: torch.device) -> tuple:
        if dev not in self._on:
            self._on[dev] = tuple([t.to(dev) for t in group]
                                  for group in self._host)
        return self._on[dev]

    def _features(self, img: torch.Tensor) -> List[torch.Tensor]:
        """[H, W, 3] in [0, 1] -> the 5 tapped feature maps [1, C, h, w]."""
        dev = img.device
        convs, biases, _ = self._weights(dev)
        x = img.to(torch.float32)
        if self.normalize:
            x = x * 2.0 - 1.0
        x = (x - torch.tensor(_SHIFT, device=dev)) / torch.tensor(
            _SCALE, device=dev)
        x = x.permute(2, 0, 1)[None]                          # NCHW
        arch = _ARCH[self.net_type]
        feats = []
        for (conv_idx, stride, pad), w, b in zip(arch["convs"], convs,
                                                 biases):
            x = torch.relu(F.conv2d(x, w, b, stride=stride, padding=pad))
            if conv_idx in arch["taps"]:
                feats.append(x)
            if conv_idx in arch["pools"]:
                k, s = arch["pools"][conv_idx]
                x = F.max_pool2d(x, kernel_size=k, stride=s)
        return feats

    @torch.no_grad()
    def __call__(self, pred: torch.Tensor,
                 target: torch.Tensor) -> torch.Tensor:
        """LPIPS of two [H, W, 3] images in [0, 1] (0-d tensor)."""
        _, _, heads = self._weights(pred.device)
        total = torch.zeros((), device=pred.device)
        for p, t, h in zip(self._features(pred),
                           self._features(target.to(pred.device)), heads):
            # richzhang's normalize_tensor: eps outside the sqrt
            pn = p / (torch.sqrt((p ** 2).sum(1, keepdim=True)) + 1e-10)
            tn = t / (torch.sqrt((t ** 2).sum(1, keepdim=True)) + 1e-10)
            total = total + ((pn - tn) ** 2 * h).sum(1).mean()
        return total
