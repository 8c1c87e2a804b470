"""Which mesh axes shard a member's parameters (``rules``)."""
