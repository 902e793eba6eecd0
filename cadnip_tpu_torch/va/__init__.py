"""Verilog-A front end and compiler of the port.

`preproc`, `parser` and `prune` are pure Python, copied from
`cadnip_tpu/va/`; `codegen` keeps the JAX package's host pre-pass and
interprets the analog block on torch tensors (`compile_va`,
`load_va_file`, `compile_va_module`).
"""
