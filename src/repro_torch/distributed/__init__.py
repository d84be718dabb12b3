"""Multi-host coordination (``collective``) and the partition rules and
leading-axis layouts (``sharding``) of the port."""
