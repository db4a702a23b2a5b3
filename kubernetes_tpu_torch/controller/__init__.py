"""Controllers (pkg/controller analogue): only what the apiserver needs
from them so far."""
