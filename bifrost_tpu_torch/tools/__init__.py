"""The observability tools over the port's proclog tree (counterparts of
the repo's tools/like_top.py, like_ps.py, like_pmap.py, like_bmon.py and
pipeline2dot.py, which read the JAX package's tree).  Each runs as
``python -m bifrost_tpu_torch.tools.<name>`` with the same arguments and
output form, and reads the tree of the processes that run the port
(`proclog.proclog_root()`)."""

__all__ = ["like_top", "like_ps", "like_pmap", "like_bmon", "pipeline2dot"]
