"""Backend profiles: every per-platform engine choice in one place.

TpuEngine resolves one profile from ``jax.default_backend()`` when it
is built and passes it down (ntt.DeviceDomain, ntt_rns.RnsDomain);
no other module asks which backend it runs on.

  * ``cpu`` -- the test configuration: limb Pippenger with scan
    reductions and stage-unrolled NTTs, which keep XLA:CPU compile
    times small.
  * ``gpu`` -- the NVIDIA H100 configuration, chosen by elimination,
    not by timing the routes against each other (PERF.md): the XLA
    batch-affine tree MSM's staging and compile did not finish within
    450 s for one 2^17-point G1 query, so the RNS signed-dense MSM runs
    every size; the stage-unrolled NTT is the layout that has passed
    its checks on the card.  The limb routes are the slowest per
    multiply (benchmarks/micro.py).  benchmarks/routes.py times each
    route.

Any other platform raises: no accelerator silently runs the CPU test
configuration.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class BackendProfile:
    name: str
    #: default MSM formulation: "grouped" (limb bucket Pippenger),
    #: "dense" (limb radix-4) or "rns" (signed-dense / tree over RNS)
    msm_style: str
    #: batch-affine tree MSM over staged affine tables (rns style)
    msm_tree: bool
    #: four-step NTT layout for domains >= ntt.FOURSTEP_MIN
    ntt_fourstep: bool


PROFILES = {
    "cpu": BackendProfile(name="cpu", msm_style="grouped", msm_tree=False,
                          ntt_fourstep=False),
    "gpu": BackendProfile(name="gpu", msm_style="rns", msm_tree=False,
                          ntt_fourstep=False),
}


def resolve_profile(platform: str) -> BackendProfile:
    """The profile for a JAX platform name; unknown platforms raise."""
    try:
        return PROFILES[platform]
    except KeyError:
        raise RuntimeError(
            f"no engine profile for JAX platform {platform!r} "
            f"(supported: {', '.join(sorted(PROFILES))})"
        ) from None
