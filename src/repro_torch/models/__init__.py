"""The live LM runtime in PyTorch: layers, GQA attention with a KV cache,
Mamba2 / SSD blocks and the model assembly for the ``dense`` and ``ssm``
families, the counterparts of ``src/repro/models/``.

Parameters live in ``nn.Module``s whose parameter names follow the
reference's parameter trees (``blocks.<i>.attn.wq.w``), so
`convert.params_from_numpy` carries the reference's weights across name
for name. The functions take those modules where the reference takes its
parameter dicts. The prefill attention reaches the flash_attention kernel
and ``ssm.ssd_chunked(use_kernel=True)`` the ssd_scan kernel, both on
CUDA tensors; on CPU tensors the kernels' plain versions run.
"""
