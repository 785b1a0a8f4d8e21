"""Clip preprocessing (``preprocess``), the log-mel frontend (``audio``,
``audio_kernel``) and short-sequence attention (``attention``); ``build``
compiles and loads their CUDA kernels."""
