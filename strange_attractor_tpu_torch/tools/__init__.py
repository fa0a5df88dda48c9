"""Tools of the port, each runnable as
``python -m strange_attractor_tpu_torch.tools.<name>``:

- :mod:`.compare_reference`: the 10^9 flagship render held to a recorded
  render of the same workload (MAD, pixel correlation, lit-support IoU);
- :mod:`.check_kernels`: every bin entry point held bit for bit to a
  sequential numpy reference on a planted stream (``certify_kernels``);
- :mod:`.tonemap_variants`: kernel T's Gas pass timed on a card against
  variants of its source, to see which operation holds it.
"""
