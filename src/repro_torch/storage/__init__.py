"""Host-side storage: the columnar graph store and the exact f32 tier
(counterpart of ``repro.storage``)."""
