"""Retrieval evaluation of the port (counterpart of :mod:`colpali_tpu.evaluation`)."""
