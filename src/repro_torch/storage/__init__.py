"""Host-side storage tiers (counterpart of ``repro.storage``)."""
