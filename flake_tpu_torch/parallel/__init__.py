"""Encoding across devices and processes (port of ``flake_tpu/parallel``).

- :mod:`.assemble`, :mod:`.runner`: the cross-shard protocol on the host
  (frame-aligned spans, global frame numbering, the chained MD5, the
  rank-ordered assembly) and its simulation in one process;
- :mod:`.mesh`: frames split over the rows of a ``(dp, sp)`` mesh, each
  group analysed and emitted on its own device, or, at the LPC levels,
  each frame's samples split over the row's sp ranks;
- :mod:`.distributed`: the protocol's transport on ``torch.distributed``;
- :mod:`.launch`: the launcher of a job of ranks.
"""
