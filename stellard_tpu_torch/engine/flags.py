"""Transaction and ledger-entry flag constants.

Reference: src/ripple_data/protocol/TxFlags.h:39-83 and
LedgerFormats.h:100-118. Exact values are protocol constants.
"""

# universal
tfFullyCanonicalSig = 0x80000000
tfUniversal = tfFullyCanonicalSig
tfUniversalMask = ~tfUniversal & 0xFFFFFFFF

# AccountSet
tfRequireDestTag = 0x00010000
tfOptionalDestTag = 0x00020000
tfRequireAuth = 0x00040000
tfOptionalAuth = 0x00080000
tfDisallowSTR = 0x00100000
tfAllowSTR = 0x00200000
tfAccountSetMask = ~(
    tfUniversal | tfRequireDestTag | tfOptionalDestTag | tfRequireAuth
    | tfOptionalAuth | tfDisallowSTR | tfAllowSTR
) & 0xFFFFFFFF

# AccountSet SetFlag/ClearFlag values
asfRequireDest = 1
asfRequireAuth = 2
asfDisableMaster = 4

# OfferCreate
tfPassive = 0x00010000
tfImmediateOrCancel = 0x00020000
tfFillOrKill = 0x00040000
tfSell = 0x00080000
tfOfferCreateMask = ~(
    tfUniversal | tfPassive | tfImmediateOrCancel | tfFillOrKill | tfSell
) & 0xFFFFFFFF

# Payment
tfNoRippleDirect = 0x00010000
tfPartialPayment = 0x00020000
tfLimitQuality = 0x00040000
tfPaymentMask = ~(
    tfUniversal | tfPartialPayment | tfLimitQuality | tfNoRippleDirect
) & 0xFFFFFFFF

# TrustSet
tfSetfAuth = 0x00010000
tfSetNoRipple = 0x00020000
tfClearNoRipple = 0x00040000
tfClearAuth = 0x00080000
tfTrustSetMask = ~(
    tfUniversal | tfSetfAuth | tfSetNoRipple | tfClearNoRipple | tfClearAuth
) & 0xFFFFFFFF

# AccountRoot ledger flags
lsfPasswordSpent = 0x00010000
lsfRequireDestTag = 0x00020000
lsfRequireAuth = 0x00040000
lsfDisallowSTR = 0x00080000
lsfDisableMaster = 0x00100000

# Offer ledger flags
lsfPassive = 0x00010000
lsfSell = 0x00020000

# RippleState ledger flags
lsfLowReserve = 0x00010000
lsfHighReserve = 0x00020000
lsfLowAuth = 0x00040000
lsfHighAuth = 0x00080000
lsfLowNoRipple = 0x00100000
lsfHighNoRipple = 0x00200000
