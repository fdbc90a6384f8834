"""The deprecation-warning category of the port's API shims.

``LacinDeprecationWarning`` lives here (dependency-free) so that
``repro_torch.fabric``, ``repro_torch.sim.report`` and the studies can
import it without cycles, as in the reference's ``repro._compat``.
"""


class LacinDeprecationWarning(DeprecationWarning):
    """Raised by thin shims kept for one release after the fabric API
    redesign; see the migration table in README.md."""
