"""Numpy oracle: exact-semantics CPU re-implementation of the reference
pipeline (LSD + RDP + FA + UKF), the port's own copy of lsdtpu/oracle/.

It stays scalar numpy on the host on purpose: it is the reference-
semantics CPU model of the C++ engine, the map prep behind
``--mapprep oracle`` and ``OnlineLocalizer(mapprep="oracle")``, and the
fallback baseline that ``lsdtpu_torch.bench`` times.  It imports no
torch; callers convert at the boundary.  ``floors`` alone (the global
relock over every gated hypothesis, and which floor a robot's scans are
matched on) computes in torch, float64 on the CPU."""
