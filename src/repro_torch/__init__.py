"""``repro_torch`` — the PyTorch/CUDA port of the butterfly LM serving path.

A second package beside the JAX reference (``repro``), written for one
NVIDIA H100. It serves ``smollm-135m-butterfly`` end to end: the paper's
butterfly sandwich replaces the dense MLP and LM-head projections of a
llama-style LM, and the paged continuous-batching engine drives it.

    from repro_torch.configs import registry
    from repro_torch.serve import Request, ServeEngine, loader

    cfg = registry.get("smollm-135m-butterfly")
    model = loader.init_params(cfg, seed=0)          # on cuda
    engine = ServeEngine(cfg, model, slots=8, max_len=512)
    fut = engine.submit(Request(prompt=[1, 2, 3], max_new_tokens=16))
    engine.run_until_idle()

Two kernels are written by hand in CUDA C++ for ``sm_90a``
(``csrc/sandwich.cu``, ``csrc/paged_attention.cu``). Each has a plain
PyTorch twin in the same module; a wrapper takes the twin only for a tensor
on the CPU (or when the caller's execution context asks for ``"torch"``:
``context="torch"``, or ``with use_execution("torch"):``; see
:mod:`repro_torch.kernels.context`), never as a fallback for a CUDA
tensor. Entry points run on ``cuda`` unless the caller
passes ``device="cpu"`` and raise when no card is present.

The package imports ``torch`` and numpy only — never ``jax`` and never the
``repro`` package.
"""
