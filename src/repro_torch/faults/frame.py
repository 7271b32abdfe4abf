"""The checksum frame's size (``repro.faults.frame``).

Every transmission attempt of a wire payload carries an 8-byte trailer
(two uint32 words: bit-sum and bit-xor of the payload's words), and the
trainers bill it per attempt, so a retransmitted payload pays the frame
again.  The sync trainers read only this size.  The frame itself
(``frame_checksum``, ``corrupt_payload``, ``corrupt_frame``,
``FramedCodec``) is run only by the event engine, and is ported with it.
"""

# Trailer size billed per transmission attempt: two uint32 words.
FRAME_BYTES = 8
