"""Encoding across devices and processes (port of ``flake_tpu/parallel``).

- :mod:`.assemble`, :mod:`.runner`: the cross-shard protocol on the host
  (frame-aligned spans, global frame numbering, the chained MD5, the
  rank-ordered assembly) and its simulation in one process;
- :mod:`.mesh`: frames split over the devices of a ``(dp, sp)`` mesh, each
  group analysed and emitted on its own device;
- :mod:`.distributed`: the protocol's transport on ``torch.distributed``;
- :mod:`.launch`: the launcher of a job of ranks.
"""
