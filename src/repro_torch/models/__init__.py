"""Model code of the port (``repro.models``): the decoder-only LM with
attention and RG-LRU recurrent blocks, run through the ``flash_attention``
and ``rglru_scan`` kernels."""
