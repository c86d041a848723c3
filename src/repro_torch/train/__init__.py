"""Training: AdamW with global-norm clipping (``optimizer``), the step and
its loop (``trainer``) and the heads-only distillation of a student from
the MC teacher (``distill``)."""
