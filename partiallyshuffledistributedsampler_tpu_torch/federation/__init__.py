"""Multi-cell federation: a global plane over independent cells.

A copy of the JAX package's ``federation/``: directory wires, per-cell
HMAC keys and shipped WAL records are byte-equal across the two
packages, so a WAL shipped by a cell of either replays in the other's.

Each cell is a self-contained :class:`~..sharding.ShardPlane` with its
own WAL tree and capability keyring; this package adds the global
namespace (:class:`CellDirectory` + the typed retryable ``wrong_cell``
redirect), cross-cell WAL shipping (:class:`WalShipper`), whole-cell
fencing and cell-kill disaster recovery, federated capability issuance
(:class:`CellKeyring`/:class:`TrustBundle`), and live tenant migration
between cells (:meth:`Federation.migrate_tenant`).  docs/FEDERATION.md
is the narrative companion.
"""

from .cell import Cell, Federation, MigrationAborted  # noqa: F401
from .directory import CellDirectory, DirectoryRef  # noqa: F401
from .keys import (  # noqa: F401
    CellKeyring,
    TrustBundle,
    sign_capability,
    verify_capability,
)
from .shipper import WalShipper  # noqa: F401
