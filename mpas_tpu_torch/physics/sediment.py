"""Kernel 5: the sedimentation of a microphysics scheme's falling species.

`sediment_species(qs, laws, rho, dz, dt, nfall)` advances every species in
`qs` (level-major [K, C] mixing ratios) through all `nfall` upwind substeps
of `kessler.sediment`, each with its fall law, and returns the new mixing
ratios and each species' surface accumulation [C] (mm == kg/m^2 of water).
For tensors on the card it is one launch of the CUDA kernel in
csrc/sediment.cu, whatever the number of species; for tensors on the CPU
it runs `sediment_species_plain`, which is `kessler.sediment` for one
species after another.

The laws are named: "rain" (`kessler._fall_velocity`), "snow"
(`wsm6._snow_fall_velocity`) and "graupel" (`wsm6._graupel_fall_velocity`);
their constants are written into the kernel's source as well. Kessler
passes rain, WSM6 rain and snow, and graupel where it carries it: the
kernel takes whatever species, levels, columns and element type it is
given.

The kernel's outputs ([S, K, C] and [S, C], handed back as views of one
tensor each) are the only memory it allocates.
"""

from __future__ import annotations

import torch

# the kernel's law codes are these names' positions
LAWS = ("rain", "snow", "graupel")
MAX_SPECIES = len(LAWS)

# kernel launches since the counter was last set to 0
launches = 0


def sediment_species_plain(qs, laws, rho, dz, dt: float, nfall: int):
    """The plain PyTorch version: `kessler.sediment` for each species with
    its law. Returns (list of q_new [K, C], list of accumulations [C])."""
    # kessler and wsm6 import this module: their laws are looked up here
    from . import kessler, wsm6
    fall = {"rain": kessler._fall_velocity,
            "snow": wsm6._snow_fall_velocity,
            "graupel": wsm6._graupel_fall_velocity}
    out = [kessler.sediment(q, rho, dz, dt, nfall, fall[law])
           for q, law in zip(qs, laws)]
    return [q for q, _ in out], [acc for _, acc in out]


def _check(qs, laws, rho, dz, nfall):
    """Raise on arguments that neither version takes (the count of species
    and laws, an unknown law, nfall, shapes) and, on the card, on what the
    kernel does not take (devices, dtypes, layout); (K, C) otherwise."""
    if not 1 <= len(qs) <= MAX_SPECIES or len(laws) != len(qs):
        raise ValueError(f"sediment_species: 1 to {MAX_SPECIES} species, one "
                         f"law each; got {len(qs)} species, {len(laws)} laws")
    unknown = [law for law in laws if law not in LAWS]
    if unknown:
        raise ValueError(f"sediment_species: unknown fall law {unknown}; "
                         f"the laws are {LAWS}")
    if int(nfall) != nfall or nfall < 1:
        raise ValueError(f"sediment_species: nfall must be a whole number "
                         f">= 1, got {nfall}")
    if rho.dim() != 2 or min(rho.shape) < 1:
        raise ValueError(f"sediment_species: rho must be a non-empty [K, C], "
                         f"got {tuple(rho.shape)}")
    named = (("dz", dz), *((f"qs[{i}]", q) for i, q in enumerate(qs)))
    for name, t in named:
        if t.shape != rho.shape:
            raise ValueError(f"sediment_species: {name} is "
                             f"{tuple(t.shape)}, rho {tuple(rho.shape)}")
    if rho.device.type == "cpu":
        return tuple(rho.shape)
    for name, t in (("rho", rho), *named):
        if t.device != rho.device or t.device.type != "cuda":
            raise ValueError(f"sediment_species: {name} on {t.device}, rho on "
                             f"{rho.device}: all on one CUDA device")
        if t.dtype not in (torch.float32, torch.float64) or t.dtype != rho.dtype:
            raise TypeError(f"sediment_species: {name} is {t.dtype}, rho "
                            f"{rho.dtype}: float32 or float64, all alike")
        if not t.is_contiguous():
            raise ValueError(f"sediment_species: {name} must be contiguous")
    return tuple(rho.shape)


def sediment_species(qs, laws, rho, dz, dt: float, nfall: int):
    """qs: [K, C] mixing ratios of 1 to 3 species, `laws` their fall laws
    (names from LAWS); rho (dry air density) and dz (layer depths) [K, C];
    all contiguous, float32 or float64 alike. Returns (list of q_new [K, C],
    list of surface accumulations [C]), in the order of `qs`."""
    global launches
    K, C = _check(qs, laws, rho, dz, nfall)
    if rho.device.type == "cpu":
        return sediment_species_plain(qs, laws, rho, dz, dt, nfall)
    from .. import cuda_build
    S = len(qs)
    q_out = torch.empty((S, K, C), dtype=rho.dtype, device=rho.device)
    acc = torch.empty((S, C), dtype=rho.dtype, device=rho.device)
    ptrs = [q.data_ptr() for q in qs] + [0] * (MAX_SPECIES - S)
    codes = [LAWS.index(law) for law in laws] + [0] * (MAX_SPECIES - S)
    suffix = "f32" if rho.dtype == torch.float32 else "f64"
    code = getattr(cuda_build.library(), f"sediment_species_{suffix}")(
        *ptrs, *codes, S, rho.data_ptr(), dz.data_ptr(), q_out.data_ptr(),
        acc.data_ptr(), K, C, int(nfall), dt / nfall,
        torch.cuda.current_stream(rho.device).cuda_stream)
    cuda_build.check(code, "sediment_species")
    launches += 1
    return list(q_out.unbind(0)), list(acc.unbind(0))
