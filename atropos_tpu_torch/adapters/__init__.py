"""Adapter parsing, matching, and caching.

Split by concern: the spec grammar (:mod:`.parser`), the adapter model
and placement flags (:mod:`.model`), SOLiD colorspace handling
(:mod:`.colorspace`), and the known-adapter cache (:mod:`.cache`). The
full surface re-exports here; semantics match the reference
(``atropos/adapters/__init__.py``).
"""
from atropos_tpu_torch.adapters.cache import (  # noqa: F401
    DEFAULT_ADAPTERS_PATH,
    DEFAULT_ADAPTERS_URL,
    AdapterCache,
)
from atropos_tpu_torch.adapters.colorspace import ColorspaceAdapter  # noqa: F401
from atropos_tpu_torch.adapters.model import (  # noqa: F401
    ADAPTER_TYPES,
    ANYWHERE,
    BACK,
    FRONT,
    LINKED,
    PREFIX,
    SUFFIX,
    Adapter,
    AdapterType,
    LinkedAdapter,
    LinkedMatch,
    where_int_to_dict,
)
from atropos_tpu_torch.adapters.parser import (  # noqa: F401
    AdapterParser,
    parse_braces,
)
