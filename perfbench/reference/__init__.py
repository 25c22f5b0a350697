"""Plain references of the benchmark's model families, one module a
family (``<family>.py``), in plain PyTorch over a dict of float32
leaves named as the port names its parameters.  They import nothing of
the port; each family module gives ``param_shapes(model)``,
``forward(params, tokens, model, prec, segments)`` and
``logits_at(params, tokens, model, prec, positions, segments)``, and
:mod:`perfbench.reference.common` the loss, AdamW and the numerics
(``prec``: ``"f32"``, or the lower precisions of the controls)."""
