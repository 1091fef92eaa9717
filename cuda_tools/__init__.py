"""Measurement tools of ``atropos_tpu_torch`` on an NVIDIA card: the timing
that ``chip_smoke.py`` uses, a comparison of ``dp_locate_word32`` with
another tree's, and an instruction count from the built kernels' SASS.
Run from the root of a checkout (``python -m cuda_tools.<tool>``); the
package ``atropos_tpu_torch`` does not import them."""
