"""``repro_torch`` — the PyTorch/CUDA port of ``repro`` (TGM).

Laid out like the reference package (``core``, ``data``, ``nn``,
``kernels``, ``models/tg``, ``train``, ``tg``). The port imports ``torch``
and numpy only: never ``jax``, never anything of ``repro`` (it keeps its own
copies of the numpy host layer). ``tests/test_torch_imports.py`` enforces
that rule. Entry points take ``device=`` and default to ``"cuda"``.
"""
