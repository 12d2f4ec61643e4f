"""Operations and bytes of the work a roofline is taken against, one file a
piece of work, counted from the host factorization's sizes (never from a
pack's format), so that a roofline reads the same work whatever implements
it."""
