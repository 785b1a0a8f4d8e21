"""Weights in the reference ``.pth`` layout.

The port's modules carry the reference's own parameter names, so a reference
checkpoint loads with ``load_state_dict``. ``state_dict_from_jax`` goes the
other way from the JAX package's ``core/torch_import.py`` converters
(``CONVERTERS``: every model of the zoo): it takes the JAX
``{"params", "batch_stats"}`` tree (as numpy arrays) of a model and
returns the port's state dict for it:

  * conv kernels HWIO -> OIHW, 3-d ones THWIO -> OITHW (with the bias
    where the JAX convolution has one); dense kernels (I, O) -> weights
    (O, I)
  * BatchNorm/LayerNorm ``scale`` -> ``weight``; ``mean``/``var`` ->
    ``running_mean``/``running_var``
  * ``TokenProjection`` splits into N linears, ``TokenLogits`` into N rows
    (12 for an AU head, 2 for the VA head)
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
    an empty prefix addresses the root, for single-module trees.

    ``lenient``: an array or subtree that the tree lacks exports nothing,
    and a split array that does not divide into its pieces neither (a
    restored checkpoint, merged into a model's own values by
    ``core/checkpointing.py``). ``groups`` lists the torch keys of each JAX
    array exported, so that a merge takes or leaves an array whole."""

    def __init__(self, variables: Mapping[str, Any], lenient: bool = False):
        self.lenient = lenient
        self.params = (variables.get("params", {}) if lenient
                       else variables["params"])
        self.stats = variables.get("batch_stats", {})
        self.sd: dict[str, torch.Tensor] = {}
        self.groups: list[list[str]] = []

    def _node(self, tree, path: str):
        for key in filter(None, path.split("/")):
            if self.lenient and (not isinstance(tree, Mapping)
                                 or key not in tree):
                return {}
            tree = tree[key]
        return tree

    def _leaf(self, node, key: str):
        """``node[key]`` as an array; None where a lenient export finds
        none."""
        if self.lenient and (not isinstance(node, Mapping)
                             or key not in node):
            return None
        return np.asarray(node[key])

    def _store(self, tkeys: list[str], values) -> None:
        """The pieces of one JAX array under ``tkeys``."""
        for tkey, value in zip(tkeys, values):
            self.sd[tkey] = torch.from_numpy(
                np.array(value, dtype=np.float32, copy=True))
        self.groups.append(list(tkeys))

    def _put(self, tkey: str, value, fn=None) -> None:
        """``fn(value)`` under ``tkey``; nothing where ``value`` is None."""
        if value is not None:
            self._store([tkey], [value if fn is None else fn(value)])

    def _splits(self, value, n: int, axis: int) -> bool:
        """Whether to split ``value`` into ``n`` along ``axis``: always in a
        strict export (np.split raises on a bad width), where it is there
        and divides in a lenient one."""
        return not self.lenient or (value is not None and value.ndim > axis
                                    and value.shape[axis] % n == 0)

    # -- leaf mappers ---------------------------------------------------------
    def linear(self, tkey: str, jpath: str, bias: bool = True) -> None:
        p = self._node(self.params, jpath)
        self._put(_join(tkey, "weight", "."), self._leaf(p, "kernel"),
                  np.transpose)
        if bias:
            self._put(_join(tkey, "bias", "."), self._leaf(p, "bias"))

    def _conv(self, tkey: str, jpath: str, axes: tuple) -> None:
        p = self._node(self.params, jpath)
        self._put(_join(tkey, "weight", "."), self._leaf(p, "kernel"),
                  lambda k: k.transpose(axes))
        if "bias" in p:
            self._put(_join(tkey, "bias", "."), self._leaf(p, "bias"))

    def conv2d(self, tkey: str, jpath: str) -> None:
        """(kH, kW, in, out) -> (out, in, kH, kW)."""
        self._conv(tkey, jpath, (3, 2, 0, 1))

    def conv3d(self, tkey: str, jpath: str) -> None:
        """(kT, kH, kW, in, out) -> (out, in, kT, kH, kW)."""
        self._conv(tkey, jpath, (4, 3, 0, 1, 2))

    def batchnorm(self, tkey: str, jpath: str) -> None:
        p = self._node(self.params, jpath)
        s = self._node(self.stats, jpath)
        for tsuf, node, key in (("weight", p, "scale"), ("bias", p, "bias"),
                                ("running_mean", s, "mean"),
                                ("running_var", s, "var")):
            self._put(_join(tkey, tsuf, "."), self._leaf(node, key))

    def layernorm(self, tkey: str, jpath: str) -> None:
        p = self._node(self.params, jpath)
        self._put(_join(tkey, "weight", "."), self._leaf(p, "scale"))
        self._put(_join(tkey, "bias", "."), self._leaf(p, "bias"))

    def raw(self, tkey: str, jpath: str) -> None:
        parent, _, name = jpath.rpartition("/")
        self._put(tkey, self._leaf(self._node(self.params, parent), name))

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

    def token_proj(self, tpre: str, jpath: str, n: int = NUM_AU,
                   stem: str = "AU") -> None:
        """(D, n*E) TokenProjection -> {stem}_linear_p1..p{n} (E, D)."""
        p = self._node(self.params, jpath)
        kernel, bias = self._leaf(p, "kernel"), self._leaf(p, "bias")
        names = [_join(tpre, f"{stem}_linear_p{i + 1}", ".")
                 for i in range(n)]
        if self._splits(kernel, n, 1):
            self._store([f"{k}.weight" for k in names],
                        [w.T for w in np.split(kernel, n, axis=1)])
        if self._splits(bias, n, 0):
            self._store([f"{k}.bias" for k in names], np.split(bias, n))

    def token_logits(self, tpre: str, jpath: str, stem: str = "AU",
                     n: int = NUM_AU) -> None:
        """(n, E) TokenLogits -> {stem}_linear_last1..last{n} (1, E) (a
        lenient export takes a kernel of n rows only)."""
        kernel = self._leaf(self._node(self.params, jpath), "kernel")
        if kernel is None or (self.lenient and len(kernel) != n):
            return
        self._store([_join(tpre, f"{stem}_linear_last{i + 1}.weight", ".")
                     for i in range(len(kernel))],
                    [row[None, :] for row in kernel])

    def au_former(self, tpre: str, jpre: str, n: int = NUM_AU,
                  stem: str = "AU") -> None:
        """AUFormerHead -> reference AU_former (heads.py:258-339); with
        n=2, stem="VA" VAFormerHead -> VA_former (heads.py:341-372)."""
        self.batchnorm(_join(tpre, f"{stem}_BN1", "."),
                       _join(jpre, "input_bn/bn", "/"))
        self.token_proj(tpre, _join(jpre, "token_proj", "/"), n, stem)
        self.raw(_join(tpre, "pos_embedding", "."),
                 _join(jpre, "pos_embedding", "/"))
        self.transformer(_join(tpre, "corr_transformer", "."),
                         _join(jpre, "corr_transformer", "/"))
        self.token_logits(tpre, _join(jpre, "token_logits", "/"), stem, n)

    def va_former(self, tpre: str, jpre: str) -> None:
        self.au_former(tpre, jpre, n=2, stem="VA")

    def mlp_head(self, tpre: str, jpre: str) -> None:
        """MLPHead (bn1, fc1, bn2, fc2) -> the reference's
        Sequential(BN1d, Linear, BN1d, Linear)."""
        self.batchnorm(f"{tpre}.0", f"{jpre}/bn1/bn")
        self.linear(f"{tpre}.1", f"{jpre}/fc1")
        self.batchnorm(f"{tpre}.2", f"{jpre}/bn2/bn")
        self.linear(f"{tpre}.3", f"{jpre}/fc2")

    def au_multihead(self, tpre: str, jpre: str) -> None:
        """AUMultihead -> AU_BN1, AU_linear_p/last{i}, AU_inter."""
        self.batchnorm(_join(tpre, "AU_BN1", "."),
                       _join(jpre, "input_bn/bn", "/"))
        self.token_proj(tpre, _join(jpre, "token_proj", "/"))
        self.token_logits(tpre, _join(jpre, "token_logits", "/"))
        if "inter" in self._node(self.params, jpre):
            self.linear(_join(tpre, "AU_inter", "."),
                        _join(jpre, "inter", "/"))

    def dense_head(self, tpre: str, jpre: str) -> None:
        """EXPHead / VAHead: bn1, fc1, [inter,] bn2, fc2."""
        for name in ("fc1", "inter", "fc2"):
            if name in self._node(self.params, jpre):
                self.linear(_join(tpre, name, "."), _join(jpre, name, "/"))
        for name in ("bn1", "bn2"):
            self.batchnorm(_join(tpre, name, "."), _join(jpre, f"{name}/bn",
                                                         "/"))

    def multitask_head(self, tpre: str, jpre: str) -> None:
        self.au_multihead(_join(tpre, "au_head", "."),
                          _join(jpre, "au_head", "/"))
        for name in ("exp_head", "va_head"):
            self.dense_head(_join(tpre, name, "."), _join(jpre, name, "/"))

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

    def bottleneck(self, tpre: str, jpre: str) -> None:
        for i in (1, 2, 3):
            self.conv2d(f"{tpre}.conv{i}", f"{jpre}/conv{i}")
            self.batchnorm(f"{tpre}.bn{i}", f"{jpre}/bn{i}/bn")
        if "ds_conv" in self._node(self.params, jpre):
            self.conv2d(f"{tpre}.downsample.0", f"{jpre}/ds_conv")
            self.batchnorm(f"{tpre}.downsample.1", f"{jpre}/ds_bn/bn")

    def vgg_trunk(self, tpre: str, jpre: str) -> None:
        """VGGFace2Extractor (layer{i}_block{j}) -> the reference's
        resnet50 naming (layer{i}.{j})."""
        self.conv2d(f"{tpre}.conv1", f"{jpre}/conv1")
        self.batchnorm(f"{tpre}.bn1", f"{jpre}/bn1/bn")
        node = self._node(self.params, jpre)
        for li in range(1, 5):
            blocks = sum(1 for k in node if k.startswith(f"layer{li}_block"))
            for bi in range(blocks):
                self.bottleneck(f"{tpre}.layer{li}.{bi}",
                                f"{jpre}/layer{li}_block{bi}")

    def van_block(self, tpre: str, jpre: str) -> None:
        """VanBlock: BN, attention (proj_1, LKA, proj_2), BN, MLP, the
        layer scales; every convolution with its bias."""
        self.batchnorm(f"{tpre}.norm1", f"{jpre}/norm1/bn")
        self.conv2d(f"{tpre}.attn.proj_1", f"{jpre}/attn/proj_1")
        for conv in ("conv0", "conv_spatial", "conv1"):
            self.conv2d(f"{tpre}.attn.spatial_gating_unit.{conv}",
                        f"{jpre}/attn/spatial_gating_unit/{conv}")
        self.conv2d(f"{tpre}.attn.proj_2", f"{jpre}/attn/proj_2")
        self.batchnorm(f"{tpre}.norm2", f"{jpre}/norm2/bn")
        self.conv2d(f"{tpre}.mlp.fc1", f"{jpre}/mlp/fc1")
        self.conv2d(f"{tpre}.mlp.dwconv.dwconv", f"{jpre}/mlp/dwconv/dwconv")
        self.conv2d(f"{tpre}.mlp.fc2", f"{jpre}/mlp/fc2")
        self.raw(f"{tpre}.layer_scale_1", f"{jpre}/layer_scale_1")
        self.raw(f"{tpre}.layer_scale_2", f"{jpre}/layer_scale_2")

    def emonet_convblock(self, tpre: str, jpre: str) -> None:
        """EmoNet's ConvBlock: three bias-free 3x3 convolutions and the
        downsample Sequential(IN, ReLU, 1x1 conv)'s ``.2``."""
        for conv in ("conv1", "conv2", "conv3"):
            self.conv2d(f"{tpre}.{conv}", f"{jpre}/{conv}")
        if "downsample" in self._node(self.params, jpre):
            self.conv2d(f"{tpre}.downsample.2", f"{jpre}/downsample")

    def unit3d(self, tpre: str, jpre: str) -> None:
        self.conv3d(f"{tpre}.conv3d", f"{jpre}/conv3d")
        self.batchnorm(f"{tpre}.bn", f"{jpre}/bn")

    def _downsample3d(self, tpre: str, jpre: str) -> None:
        if "ds_conv" in self._node(self.params, jpre):
            self.conv3d(f"{tpre}.downsample.0", f"{jpre}/ds_conv")
            self.batchnorm(f"{tpre}.downsample.1", f"{jpre}/ds_bn")

    def mc3d_block(self, tpre: str, jpre: str) -> None:
        """mc3d's BasicBlock3D -> torchvision's conv{1,2}.{0,1}."""
        for i in (1, 2):
            self.conv3d(f"{tpre}.conv{i}.0", f"{jpre}/conv{i}")
            self.batchnorm(f"{tpre}.conv{i}.1", f"{jpre}/bn{i}")
        self._downsample3d(tpre, jpre)

    def r2plus1d_block(self, tpre: str, jpre: str) -> None:
        """R2Plus1DBlock -> torchvision's Conv2Plus1D Sequentials
        ``conv{1,2}.0.{0,1,3}`` and their BNs ``conv{1,2}.1``."""
        for i in (1, 2):
            self.conv3d(f"{tpre}.conv{i}.0.0", f"{jpre}/conv{i}_s")
            self.batchnorm(f"{tpre}.conv{i}.0.1", f"{jpre}/conv{i}_bn_mid")
            self.conv3d(f"{tpre}.conv{i}.0.3", f"{jpre}/conv{i}_t")
            self.batchnorm(f"{tpre}.conv{i}.1", f"{jpre}/bn{i}")
        self._downsample3d(tpre, jpre)


def _export_avformer(e: Exporter) -> None:
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


def _export_vformer(e: Exporter) -> None:
    e.resformer("video_model.s_former", "video_model/s_former")
    e.tformer("video_model.t_former", "video_model/t_former")
    e.mlp_head("fc", "fc")


def _export_audio(e: Exporter) -> None:
    e.resnet18("audio_model.resnet", "audio_model/resnet")
    if "au_head" in e.params:
        e.au_former("au_head", "au_head")


def _export_resnet(e: Exporter) -> None:
    e.resnet18("base_model", "base_model")
    e.linear("fc.1", "fc")


def _export_sformer(e: Exporter) -> None:
    e.resformer("base_model", "base_model")
    e.mlp_head("fc", "fc")
    if "au_head" in e.params:
        e.au_former("au_head", "au_head")
    if "va_head" in e.params:
        e.va_former("va_head", "va_head")


def _export_tformer(e: Exporter) -> None:
    e.resformer("video_model.s_former", "video_model/s_former")
    e.au_former("video_model.au_head", "video_model/au_head")
    e.tformer("video_model.t_former", "video_model/t_former")
    e.mlp_head("fc", "fc")
    e.former_au_head("au_head", "au_head")


def _export_dsformer(e: Exporter) -> None:
    e.resformer("rgb_model", "rgb_model")
    e.resformer("mask_model", "mask_model")
    e.mlp_head("fc", "fc")


def _export_vggformer(e: Exporter) -> None:
    s = "video_model.s_former"
    e.vgg_trunk(f"{s}.VGG_model", "s_former/VGG_model")
    e.conv2d(f"{s}.conv", "s_former/conv")
    e.raw(f"{s}.pos_embedding", "s_former/pos_embedding")
    e.transformer(f"{s}.spatial_transformer", "s_former/spatial_transformer")
    e.tformer("video_model.t_former", "t_former")
    e.linear("fc.0", "fc1")
    e.batchnorm("fc.1", "fc_bn/bn")
    e.linear("fc.3", "fc2")


def _export_van(e: Exporter) -> None:
    node = e._node(e.params, "base_model")
    for i in range(1, 5):
        pe, pj = f"base_model.patch_embed{i}", f"base_model/patch_embed{i}"
        e.conv2d(f"{pe}.proj", f"{pj}/proj")
        e.batchnorm(f"{pe}.norm", f"{pj}/norm/bn")
        blocks = sum(1 for k in node if k.startswith(f"block{i}_"))
        for j in range(blocks):
            e.van_block(f"base_model.block{i}.{j}", f"base_model/block{i}_{j}")
        e.layernorm(f"base_model.norm{i}", f"base_model/norm{i}")
    e.mlp_head("fc", "fc")
    e.au_former("au_head", "au_head")


def _export_emonet(e: Exporter) -> None:
    node = e._node(e.params, "base_model")
    e.conv2d("base_model.conv1", "base_model/conv1")
    for name in ("conv2", "conv3", "conv4"):
        e.emonet_convblock(f"base_model.{name}", f"base_model/{name}")
    modules = sum(1 for k in node if k.startswith("top_m_"))
    for i in range(modules):
        for block in e._node(node, f"m{i}"):   # b1_4 ... b3_1, b2_plus_1
            e.emonet_convblock(f"base_model.m{i}.{block}",
                               f"base_model/m{i}/{block}")
        e.emonet_convblock(f"base_model.top_m_{i}", f"base_model/top_m_{i}")
        for conv in (f"conv_last{i}", f"l{i}", f"bl{i}", f"al{i}"):
            if conv in node:
                e.conv2d(f"base_model.{conv}", f"base_model/{conv}")
    e.conv2d("base_model.conv1x1_input_emo_2",
             "base_model/conv1x1_input_emo_2")
    blocks = sum(1 for k in node if k.startswith("emo_convs_"))
    for bi in range(blocks):               # emo_net_2 = [ConvBlock, MaxPool]
        e.emonet_convblock(f"base_model.emo_net_2.{2 * bi}",
                           f"base_model/emo_convs_{bi}")
    e.linear("base_model.emo_fc_2.0", "base_model/emo_fc_1")
    e.batchnorm("base_model.emo_fc_2.1", "base_model/emo_fc_bn")
    e.linear("base_model.emo_fc_2.3", "base_model/emo_fc_2")
    e.au_former("base_model.au_head", "base_model/au_head")


def _export_fc_bn_fc(e: Exporter) -> None:
    """fc1, fc_bn, fc2 -> the reference's Sequential(Linear, BN1d,
    Linear)."""
    e.linear("fc.0", "fc1")
    e.batchnorm("fc.1", "fc_bn")
    e.linear("fc.2", "fc2")


def _export_i3d(e: Exporter) -> None:
    for unit, node in e._node(e.params, "video_model").items():
        if unit.startswith("Mixed_"):
            for branch in node:
                e.unit3d(f"video_model.{unit}.{branch}",
                         f"video_model/{unit}/{branch}")
        else:
            e.unit3d(f"video_model.{unit}", f"video_model/{unit}")
    _export_fc_bn_fc(e)


def _export_mc3d(e: Exporter) -> None:
    e.conv3d("video_model.stem.0", "video_model/stem_conv")
    e.batchnorm("video_model.stem.1", "video_model/stem_bn")
    for li in range(1, 5):
        for bi in range(2):
            e.mc3d_block(f"video_model.layer{li}.{bi}",
                         f"video_model/layer{li}_block{bi}")
    _export_fc_bn_fc(e)


def _export_tsav(e: Exporter) -> None:
    e.resnet18("audio_model.resnet", "audio_model/resnet")
    t, j = "video_model.r2plus1d", "video_model"
    e.conv3d(f"{t}.stem.0", f"{j}/stem_s")
    e.batchnorm(f"{t}.stem.1", f"{j}/stem_bn1")
    e.conv3d(f"{t}.stem.3", f"{j}/stem_t")
    e.batchnorm(f"{t}.stem.4", f"{j}/stem_bn2")
    for li in range(1, 5):
        for bi in range(2):
            e.r2plus1d_block(f"{t}.layer{li}.{bi}",
                             f"{j}/layer{li}_block{bi}")
    e.linear("fc.1", "fc")


#: model name -> the mapper of its whole tree (the inverse of the JAX
#: package's ``CONVERTERS`` entry of that name)
EXPORTERS = {"avformer": _export_avformer, "vformer": _export_vformer,
             "audio": _export_audio, "resnet": _export_resnet,
             "sformer": _export_sformer, "tformer": _export_tformer,
             "dsformer": _export_dsformer, "vggformer": _export_vggformer,
             "van": _export_van, "emonet": _export_emonet, "i3d": _export_i3d,
             "mc3d": _export_mc3d, "tsav": _export_tsav}


def export_jax(variables: Mapping[str, Any], model_name: str = "avformer",
               lenient: bool = False) -> Exporter:
    """The :class:`Exporter` of ``model_name`` run over ``variables``."""
    if model_name not in EXPORTERS:
        raise NotImplementedError(
            f"no state dict export for {model_name!r}; available: "
            f"{sorted(EXPORTERS)}")
    e = Exporter(variables, lenient=lenient)
    EXPORTERS[model_name](e)
    return e


def state_dict_from_jax(variables: Mapping[str, Any],
                        model_name: str = "avformer"
                        ) -> dict[str, torch.Tensor]:
    """JAX variables of ``model_name`` -> the port's (reference layout)
    state dict; the inverse of that model's converter in
    ``core/torch_import.py``."""
    return export_jax(variables, model_name).sd


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
