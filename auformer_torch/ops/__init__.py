"""Clip preprocessing (``preprocess``), the device AutoAugment
(``augment_device``), the log-mel frontend (``audio``, ``audio_kernel``)
and short-sequence attention (``attention``); ``build`` compiles and loads
their CUDA kernels."""
