"""Refinement and Krylov drivers: on the device (:mod:`.gmres`, :mod:`.ir`)
and on the host (:mod:`.gmres_np`)."""
