"""Model, inference and training configuration (copy of cotr_tpu/config.py,
same fields and JSON form).

Defaults reproduce the published model: ResNet-50 to layer3, d_model 256,
8 heads, 6+6 layers, FFN 1024, lin_sine positional embedding.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Optional, Tuple

_LAYER_CHANNELS = {"layer1": 256, "layer2": 512, "layer3": 1024,
                   "layer4": 2048}
_LAYER_STRIDE = {"layer1": 4, "layer2": 8, "layer3": 16, "layer4": 32}


@dataclasses.dataclass(frozen=True)
class COTRConfig:
    """Model hyper-parameters."""

    backbone: str = "resnet50"
    layer: str = "layer3"
    hidden_dim: int = 256
    nheads: int = 8
    enc_layers: int = 6
    dec_layers: int = 6
    #: acts in ``train()`` mode only: attention probabilities, after the
    #: FFN's ReLU, and both residual branches of every layer
    dropout: float = 0.1
    dilation: bool = False
    position_embedding: str = "lin_sine"  # or "exp_sine"
    activation: str = "relu"
    #: compute dtype for backbone+transformer ("float32" or "bfloat16");
    #: params are float32 and the correspondence head always runs fp32.
    dtype: str = "float32"
    #: kept for JSON compatibility with cotr_tpu. In the port
    #: ``MultiHeadAttention.forward`` routes by what it can observe: the
    #: hand-written kernel (its plain version on the CPU) when there is no
    #: mask, no active dropout and no gradient wanted, the einsum path
    #: otherwise (models/transformer.py, ops/attention.py).
    use_flash_attention: bool = False
    #: recompute each transformer layer in the backward pass
    #: (``torch.utils.checkpoint``): one more forward of the layers for
    #: activation memory that no longer grows with their number.
    remat: bool = False

    @property
    def backbone_channels(self) -> int:
        return _LAYER_CHANNELS[self.layer]

    @property
    def backbone_stride(self) -> int:
        s = _LAYER_STRIDE[self.layer]
        return s // 2 if (self.dilation and self.layer == "layer4") else s

    @property
    def dim_feedforward(self) -> int:
        # the FFN width is tied to the backbone channel count
        return self.backbone_channels

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "COTRConfig":
        return cls(**json.loads(s))


@dataclasses.dataclass(frozen=True)
class InferenceConfig:
    """Sparse/dense engine settings. ``zoom_ins`` is
    np.linspace(0.5, 0.0625, 4), the demos' schedule."""

    zoom_ins: Tuple[float, ...] = (0.5, 0.354166667, 0.208333333, 0.0625)
    converge_iters: int = 1
    batch_size: int = 32
    max_corrs: int = 1000
    mode: str = "stretching"  # or "tile"
    #: queries per shared crop-pair in grouped refinement
    max_load: int = 256


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training settings."""

    learning_rate: float = 1e-4
    lr_backbone: float = 0.0
    #: "constant" or "cosine": decay every group's rate from its base to
    #: base*lr_final_frac over lr_decay_steps.
    lr_schedule: str = "constant"
    lr_decay_steps: int = 0
    lr_final_frac: float = 0.03
    batch_size: int = 24
    max_iter: int = 300_000
    valid_iter: int = 1000
    #: cadence (in steps) of train-loop tensorboard scalars/histograms
    tb_iter: int = 50
    num_kp: int = 100
    bidirectional: bool = True
    cycle_consis: bool = True
    seed: int = 0
    #: the data-parallel world size: the ranks of the torch.distributed
    #: process group (torchrun --nproc_per_node N), each on one device.
    #: If given it must equal the world size (1 without a process group)
    #: and divide batch_size; the Trainer raises otherwise.
    num_devices: Optional[int] = None
    out_dir: str = "out"
    suffix: str = ""

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)


def compact_name(model_cfg: COTRConfig, train_cfg: TrainConfig,
                 dataset_name: str = "megadepth") -> str:
    """Deterministic run naming."""
    name = (
        f"model:cotr_{model_cfg.backbone}_{model_cfg.layer}"
        f"_{model_cfg.hidden_dim}"
        f"_dset:{dataset_name}"
        f"_bs:{train_cfg.batch_size}"
        f"_pe:{model_cfg.position_embedding}"
        f"_lrbackbone:{train_cfg.lr_backbone}"
    )
    if train_cfg.suffix:
        name += f"_suffix:{train_cfg.suffix}"
    return name


def save_params_json(path: str, model_cfg: COTRConfig, train_cfg: TrainConfig,
                     extra: Optional[Dict[str, Any]] = None) -> None:
    """Write a params.json for config-drift detection."""
    payload = {
        "model": dataclasses.asdict(model_cfg),
        "train": dataclasses.asdict(train_cfg),
    }
    if extra:
        payload["extra"] = extra
    with open(path, "w") as f:
        json.dump(payload, f, indent=2, sort_keys=True)


def build_scenes_name_list(dataset_config: Dict[str, Any],
                           scene_ids: Any) -> list:
    """Expand scene/sequence ids through directory templates:
    dataset_config provides format templates {scene_dir,image_dir,depth_dir}
    with ``{scene}``/``{seq}`` placeholders; scene_ids is a list of
    (scene, seq) pairs or "scene/seq" strings."""
    out = []
    for item in scene_ids:
        if isinstance(item, str):
            scene, _, seq = item.partition("/")
        else:
            scene, seq = item
        out.append({
            k: dataset_config[k].format(scene=scene, seq=seq)
            for k in ("scene_dir", "image_dir", "depth_dir")
        })
    return out


def check_params_json(path: str, model_cfg: COTRConfig,
                      train_cfg: TrainConfig) -> bool:
    """True iff an existing params.json matches the given configs.

    A field added after a run was launched is absent from its saved
    params.json and is read as holding the dataclass default, so an
    otherwise identical resume is not refused. That is only sound while
    every new field's default equals what old runs did without it."""
    with open(path) as f:
        old = json.load(f)
    new = {
        "model": dataclasses.asdict(model_cfg),
        "train": dataclasses.asdict(train_cfg),
    }
    defaults = {"model": dataclasses.asdict(COTRConfig()),
                "train": dataclasses.asdict(TrainConfig())}
    for sect in ("model", "train"):
        if isinstance(old.get(sect), dict):
            for field, dval in defaults[sect].items():
                old[sect].setdefault(field, dval)
    return (old.get("model") == new["model"]
            and old.get("train") == new["train"])
