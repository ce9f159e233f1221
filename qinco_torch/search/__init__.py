"""The search pipeline of the port (counterpart of ``qinco_tpu/search``):
the native IVF index with the coarse probe and LUTs on the device
(:mod:`.index`), the index build (:mod:`.index_build`), the pairwise
mid-rerank decoder (:mod:`.pairwise_decoder`), the operating-point grid
(:mod:`.operating_points`, :mod:`.optim_order`), the search loops
(:mod:`.search`) and the flat two-stage search (:mod:`.two_stage`).  Importing it builds nothing: the native library is
built at its first use."""
