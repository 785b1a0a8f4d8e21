"""Weights in the reference ``.pth`` layout.

The port's modules carry the reference's own parameter names, so a reference
checkpoint loads with ``load_state_dict``. ``state_dict_from_jax`` goes the
other way from the JAX package's ``core/torch_import.py::convert_avformer``:
it takes the JAX ``{"params", "batch_stats"}`` tree (as numpy arrays) and
returns the port's state dict:

  * conv kernels HWIO -> OIHW; dense kernels (I, O) -> weights (O, I)
  * BatchNorm/LayerNorm ``scale`` -> ``weight``; ``mean``/``var`` ->
    ``running_mean``/``running_var``
  * ``TokenProjection`` splits into 12 linears, ``TokenLogits`` into 12 rows
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from .. import NUM_AU


def _join(prefix: str, name: str, sep: str) -> str:
    return f"{prefix}{sep}{name}" if prefix else name


class Exporter:
    """Accumulates a reference-layout state dict from a JAX variables tree.
    Each mapper takes the torch key prefix and the JAX path ('/'-joined);
    an empty prefix addresses the root, for single-module trees."""

    def __init__(self, variables: Mapping[str, Any]):
        self.params = variables["params"]
        self.stats = variables.get("batch_stats", {})
        self.sd: dict[str, torch.Tensor] = {}

    @staticmethod
    def _node(tree, path: str):
        for key in filter(None, path.split("/")):
            tree = tree[key]
        return tree

    def _put(self, tkey: str, value) -> None:
        self.sd[tkey] = torch.from_numpy(
            np.array(value, dtype=np.float32, copy=True))

    # -- leaf mappers ---------------------------------------------------------
    def linear(self, tkey: str, jpath: str, bias: bool = True) -> None:
        p = self._node(self.params, jpath)
        self._put(_join(tkey, "weight", "."), np.asarray(p["kernel"]).T)
        if bias:
            self._put(_join(tkey, "bias", "."), p["bias"])

    def conv2d(self, tkey: str, jpath: str) -> None:
        kernel = np.asarray(self._node(self.params, jpath)["kernel"])
        self._put(_join(tkey, "weight", "."), kernel.transpose(3, 2, 0, 1))

    def batchnorm(self, tkey: str, jpath: str) -> None:
        p = self._node(self.params, jpath)
        s = self._node(self.stats, jpath)
        for tsuf, value in (("weight", p["scale"]), ("bias", p["bias"]),
                            ("running_mean", s["mean"]),
                            ("running_var", s["var"])):
            self._put(_join(tkey, tsuf, "."), value)

    def layernorm(self, tkey: str, jpath: str) -> None:
        p = self._node(self.params, jpath)
        self._put(_join(tkey, "weight", "."), p["scale"])
        self._put(_join(tkey, "bias", "."), p["bias"])

    def raw(self, tkey: str, jpath: str) -> None:
        self._put(tkey, self._node(self.params, jpath))

    # -- composite mappers ----------------------------------------------------
    def transformer(self, tpre: str, jpre: str) -> None:
        """layers_{i}/{norm1, attn, norm2, mlp} -> the reference's
        layers.{i}.0 = Residual(PreNorm(Attention)), .1 = ...(FeedForward)."""
        node = self._node(self.params, jpre)
        depth = sum(1 for k in node if k.startswith("layers_"))
        for i in range(depth):
            t0 = _join(tpre, f"layers.{i}.0.fn", ".")
            t1 = _join(tpre, f"layers.{i}.1.fn", ".")
            j = _join(jpre, f"layers_{i}", "/")
            self.layernorm(f"{t0}.norm", f"{j}/norm1")
            self.linear(f"{t0}.fn.to_qkv", f"{j}/attn/to_qkv", bias=False)
            if "to_out" in self._node(self.params, f"{j}/attn"):
                self.linear(f"{t0}.fn.to_out.0", f"{j}/attn/to_out")
            self.layernorm(f"{t1}.norm", f"{j}/norm2")
            self.linear(f"{t1}.fn.net.0", f"{j}/mlp/fc1")
            self.linear(f"{t1}.fn.net.3", f"{j}/mlp/fc2")

    def token_proj(self, tpre: str, jpath: str) -> None:
        """(D, 12*E) TokenProjection -> AU_linear_p1..p12 (E, D)."""
        p = self._node(self.params, jpath)
        kernels = np.split(np.asarray(p["kernel"]), NUM_AU, axis=1)
        biases = np.split(np.asarray(p["bias"]), NUM_AU)
        for i in range(NUM_AU):
            self._put(_join(tpre, f"AU_linear_p{i + 1}.weight", "."),
                      kernels[i].T)
            self._put(_join(tpre, f"AU_linear_p{i + 1}.bias", "."),
                      biases[i])

    def token_logits(self, tpre: str, jpath: str) -> None:
        """(12, E) TokenLogits -> AU_linear_last1..last12 (1, E)."""
        kernel = np.asarray(self._node(self.params, jpath)["kernel"])
        for i, row in enumerate(kernel):
            self._put(_join(tpre, f"AU_linear_last{i + 1}.weight", "."),
                      row[None, :])

    def au_former(self, tpre: str, jpre: str) -> None:
        """AUFormerHead -> reference AU_former (heads.py:258-339)."""
        self.batchnorm(_join(tpre, "AU_BN1", "."),
                       _join(jpre, "input_bn/bn", "/"))
        self.token_proj(tpre, _join(jpre, "token_proj", "/"))
        self.raw(_join(tpre, "pos_embedding", "."),
                 _join(jpre, "pos_embedding", "/"))
        self.transformer(_join(tpre, "corr_transformer", "."),
                         _join(jpre, "corr_transformer", "/"))
        self.token_logits(tpre, _join(jpre, "token_logits", "/"))

    def former_au_head(self, tpre: str, jpre: str) -> None:
        self.raw(_join(tpre, "pos_embedding", "."),
                 _join(jpre, "pos_embedding", "/"))
        self.transformer(_join(tpre, "corr_transformer", "."),
                         _join(jpre, "corr_transformer", "/"))
        self.token_logits(tpre, _join(jpre, "token_logits", "/"))

    def resnet_block(self, tpre: str, jpre: str) -> None:
        self.conv2d(f"{tpre}.conv1", f"{jpre}/conv1")
        self.batchnorm(f"{tpre}.bn1", f"{jpre}/bn1/bn")
        self.conv2d(f"{tpre}.conv2", f"{jpre}/conv2")
        self.batchnorm(f"{tpre}.bn2", f"{jpre}/bn2/bn")
        if "ds_conv" in self._node(self.params, jpre):
            self.conv2d(f"{tpre}.downsample.0", f"{jpre}/ds_conv")
            self.batchnorm(f"{tpre}.downsample.1", f"{jpre}/ds_bn/bn")

    def resnet18(self, tpre: str, jpre: str) -> None:
        """ResNet18/ResFormerTrunk convs -> torchvision resnet18 naming."""
        self.conv2d(_join(tpre, "conv1", "."), _join(jpre, "stem/conv1", "/"))
        self.batchnorm(_join(tpre, "bn1", "."),
                       _join(jpre, "stem/bn1/bn", "/"))
        for li in range(1, 5):
            layer = self._node(self.params, _join(jpre, f"layer{li}", "/"))
            for bi in range(len(layer)):
                self.resnet_block(_join(tpre, f"layer{li}.{bi}", "."),
                                  _join(jpre, f"layer{li}/block{bi}", "/"))

    def resformer(self, tpre: str, jpre: str) -> None:
        self.resnet18(tpre, jpre)
        self.raw(_join(tpre, "pos_embedding", "."),
                 _join(jpre, "pos_embedding", "/"))
        self.transformer(_join(tpre, "spatial_transformer", "."),
                         _join(jpre, "spatial_transformer", "/"))

    def tformer(self, tpre: str, jpre: str) -> None:
        self.raw(_join(tpre, "cls_token", "."), _join(jpre, "cls_token", "/"))
        self.raw(_join(tpre, "pos_embedding", "."),
                 _join(jpre, "pos_embedding", "/"))
        self.transformer(_join(tpre, "spatial_transformer", "."),
                         _join(jpre, "transformer", "/"))


def state_dict_from_jax(variables: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """JAX TwoStreamAuralVisualFormer variables -> the port's (reference
    layout) avformer state dict; the inverse of ``convert_avformer``."""
    e = Exporter(variables)
    e.resnet18("audio_model.audio_model.resnet",
               "audio_model/audio_model/resnet")
    e.au_former("audio_model.au_head", "audio_model/au_head")
    e.resformer("video_model.video_model.s_former",
                "video_model/video_model/s_former")
    e.tformer("video_model.video_model.t_former",
              "video_model/video_model/t_former")
    e.au_former("video_model.au_head", "video_model/au_head")
    if "au_head" in e.params:
        e.former_au_head("au_head", "au_head")
    return e.sd


def load_weights(model: torch.nn.Module,
                 state_dict: Mapping[str, Any]) -> None:
    """``load_state_dict`` of a reference-layout dict (tensors or numpy
    arrays). Only BatchNorm's ``num_batches_tracked`` may be missing."""
    sd = {k: torch.as_tensor(v) for k, v in state_dict.items()}
    missing, unexpected = model.load_state_dict(sd, strict=False)
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    if missing or unexpected:
        raise KeyError(f"state dict does not fit the model: missing "
                       f"{missing[:8]} ({len(missing)}), unexpected "
                       f"{unexpected[:8]} ({len(unexpected)})")


def load_reference_state_dict(path: str) -> dict[str, torch.Tensor]:
    """A reference ``.pth`` checkpoint (optionally under ``state_dict``),
    with the DDP ``module.`` prefix stripped (avformer.py:28-35)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return {k.replace("module.", ""): v for k, v in sd.items()}
