"""PyTorch / CUDA port of the WASH system, beside the JAX package ``repro``.

Same subpackage layout as ``repro`` (configs, core, kernels, models,
serving, train, launch), so each module's counterpart is found by path.
The package imports ``torch`` only: it carries its own copy of every
piece of ``repro`` it needs.  Parameters keep the JAX package's layout
(linear weights ``(d_in, d_out)``, stacked ``blocks`` leaves with a
leading layer axis), so checkpoints move between the two packages as
they are.
"""
