"""Host-side netCDF I/O for MPAS grid and history files.

The reference wraps the netCDF C library in Terra shims
(mesh_loading/netcdf_tasks.rg:13-155).  Here all I/O is host-side Python:
MPAS grid files are netCDF classic (CDF-1/2), which `scipy.io.netcdf_file`
reads and writes natively — no C library dependency.
"""

from __future__ import annotations

import numpy as np
from scipy.io import netcdf_file


def read_netcdf(path: str, variables=None) -> dict:
    """Read a netCDF classic file into {name: ndarray}, plus '_dims'."""
    f = netcdf_file(path, "r", mmap=False)
    try:
        out = {"_dims": dict(f.dimensions)}
        names = variables if variables is not None else list(f.variables)
        for name in names:
            v = f.variables[name]
            # copy out of scipy's big-endian buffers into native dtype
            data = np.ascontiguousarray(v.data)
            if data.dtype.byteorder == ">":
                data = data.astype(data.dtype.newbyteorder("="))
            out[name] = data
        return out
    finally:
        f.close()


def write_netcdf(path: str, dims: dict, variables: dict, attrs: dict | None = None):
    """Write a netCDF classic file.

    `variables` maps name -> (dim_names_tuple, ndarray).  Equivalent of the
    reference's write_output / write_output_plotting definition phase
    (mesh_loading/mesh_loading.rg:490-807).
    """
    f = netcdf_file(path, "w")
    try:
        for name, size in dims.items():
            f.createDimension(name, size)
        for name, (dim_names, data) in variables.items():
            data = np.asarray(data)
            var = f.createVariable(name, data.dtype, dim_names)
            var[:] = data
        if attrs:
            for k, v in attrs.items():
                setattr(f, k, v)
        f.flush()
    finally:
        f.close()
