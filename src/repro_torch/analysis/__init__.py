"""Audits of what the port's traced programs do.

:mod:`repro_torch.analysis.trace_audit` is the counterpart of the JAX
package's ``repro.analysis.jaxpr_audit``: it runs the port's entry points
(train forward and backward, chunk prefill, the device-resident decode
chunk, both sequence-parallel attention forms) under a dispatch-mode
recorder and holds them to the same three contracts (TX001–TX003). The
JAX package's AST lint (``repro.analysis.astlint``) already walks
``src/repro_torch/``.
"""
