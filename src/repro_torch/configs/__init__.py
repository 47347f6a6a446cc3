"""Architecture configs: the ``ModelCfg`` schema (``base``), the registry
of the ten assigned LM architectures with their ``reduced`` smoke sizes
(``registry``), and one module per architecture. Copies of the JAX
package's ``configs/``; pure data."""
